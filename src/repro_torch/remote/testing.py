"""Test/CI helpers: spawn a remote worker as a real subprocess.

In-process workers (`start_server` on a thread) cover protocol and
parity tests; the subprocess spawner exists for the robustness tests
that SIGKILL a worker mid-run — an in-process server cannot die without
taking the test down with it.

The worker runs ``python -m repro_torch.launch.remote_worker`` with the
port's `src` on PYTHONPATH, on its default device ("cuda") unless the
caller passes `device`. Its kernels load from the same build directory
as the caller's (`kernels/build.py`), so a worker started after a build
reuses the compiled libraries.
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading
from typing import List, Optional, Sequence, Tuple

import repro_torch


def worker_argv(*, host: str = "127.0.0.1", port: int = 0,
                name: str = "remote", models: Sequence[str] = ("sm", "lg"),
                sm_ratios: Sequence[float] = (0.8, 0.5, 0.0),
                lg_ratios: Sequence[float] = (0.8, 0.5, 0.3),
                include_cheap: bool = True, model_seed: int = 1,
                device: Optional[str] = None,
                extra: Sequence[str] = ()) -> List[str]:
    argv = [sys.executable, "-m", "repro_torch.launch.remote_worker",
            "--host", host, "--port", str(port), "--name", name,
            "--models", ",".join(models),
            "--sm-ratios", ",".join(str(r) for r in sm_ratios),
            "--lg-ratios", ",".join(str(r) for r in lg_ratios),
            "--model-seed", str(model_seed)]
    if not include_cheap:
        argv.append("--no-cheap")
    if device is not None:
        argv += ["--device", str(device)]
    argv.extend(extra)
    return argv


def spawn_worker(timeout_s: float = 120.0, **kwargs
                 ) -> Tuple[subprocess.Popen, str]:
    """Start a worker subprocess and wait for its LISTENING line.
    Returns (proc, "host:port"); `proc.device` holds what the worker's
    DEVICE line named (its torch device and, on CUDA, the card). Kill
    the proc yourself (it is a real process — SIGKILL it to simulate a
    worker crash)."""
    env = dict(os.environ)
    src_root = os.path.dirname(os.path.dirname(
        os.path.abspath(repro_torch.__file__)))
    env["PYTHONPATH"] = src_root + os.pathsep \
        + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        worker_argv(**kwargs), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)

    address: Optional[str] = None
    proc.device = None                               # type: ignore
    deadline_lines: List[str] = []

    def _fail(reason: str):
        proc.kill()
        raise RuntimeError(
            f"remote worker failed to start ({reason}); output:\n"
            + "".join(deadline_lines))

    timer = threading.Timer(timeout_s, proc.kill)
    timer.start()
    try:
        assert proc.stdout is not None
        for line in proc.stdout:
            deadline_lines.append(line)
            if line.startswith("DEVICE "):
                proc.device = line.split(None, 1)[1].strip()  # type: ignore
            if line.startswith("LISTENING "):
                address = line.split(None, 1)[1].strip()
                break
        if address is None:
            _fail("no LISTENING line before exit/timeout")
    finally:
        timer.cancel()

    # drain the rest of stdout so the worker never blocks on a full pipe
    def _drain(stream):
        try:
            for _ in stream:
                pass
        except ValueError:
            pass

    threading.Thread(target=_drain, args=(proc.stdout,),
                     daemon=True).start()
    return proc, address
