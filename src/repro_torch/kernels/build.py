"""Build the port's CUDA kernels and load them with ctypes.

Each source `csrc/<name>.cu` has a plain C interface and compiles on its
own, with no PyTorch headers, into `lib<name>-<digest>.so`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o <build dir>/lib<name>-<digest>.so csrc/<name>.cu

plus the source's own flags (`EXTRA_FLAGS`: kernel E, `beta_bounds.cu`,
compiles with -fmad=false to keep the plain version's rounding).

The digest hashes the source and the flags, so an edited source builds
anew and an unchanged one is reused. The build directory is `build/kernels`
at the root of the checkout (listed in `.gitignore`), or the directory
named by REPRO_TORCH_BUILD_DIR. A kernel builds at its first launch;
`build()` builds a set of them in parallel (one nvcc per source, all
started together) and returns the seconds each took.

Pointer arguments and the stream are `ctypes.c_void_p`; every C entry
point returns `cudaGetLastError()`, which the wrappers turn into an
exception. Nothing here falls back to another implementation: a missing
`nvcc` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("decode_attention", "expected_attention", "prefill_attention",
           "prefill_attention_tc", "beta_bounds")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# per-source flags: kernel E keeps the plain version's float32 rounding
# points (no product contracted into a sum, IEEE division and square root)
EXTRA_FLAGS = {"beta_bounds": ("-fmad=false", "-prec-div=true",
                               "-prec-sqrt=true", "-ftz=false")}


def flags(name: str):
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())
BUILD_ENV = "REPRO_TORCH_BUILD_DIR"

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get(BUILD_ENV)
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked at $NVCC, PATH and "
                       f"{home}/bin): the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags(name)).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) that are not built yet,
    one nvcc process per source, all running at once. Returns the wall
    seconds of each compile (0.0 for a library that was already there)."""
    names = list(SOURCES if names is None else names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            procs[name] = None
            continue
        nvcc = nvcc or nvcc_path()
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    seconds: Dict[str, float] = {}
    errors = []
    for name, job in procs.items():
        if job is None:
            seconds[name] = 0.0
            continue
        proc, tmp, target, t0 = job
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
