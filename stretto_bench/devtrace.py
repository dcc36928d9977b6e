"""Timing and tracing on the card.

`StepClock` times one step with CUDA events (device timestamps, a
microsecond's resolution), from just before the step's first call to
just after its result reached the host. On a CPU device (the tests) it
falls back to the host clock.

`traced(device)` runs a window under `torch.profiler` with CUDA activity
only (no per-op host recording, which would slow the host's dispatch
and inflate the idle share). On exit the Chrome trace is written to a
temporary file under TMPDIR, read and deleted. The result holds every
device operation (kernels, copies, fills) as [name, seconds], the
seconds in which some operation ran (`busy_s`), the traced window's
host-clock length (`window_s`), and the idle gaps between operations,
each named by the runtime call the host was in while the card waited,
or else by the operation it waited for.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import tempfile
import time
from typing import Dict, List

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    """Hand the memory of dropped tensors back (before the reference)."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def settle() -> None:
    """End of set-up: collect its garbage and move every object it left
    (modules, inputs, the warm-up's) out of the collector's way
    (`gc.freeze`), so a full collection inside the window scans only
    what the window makes, as in a server that has run for a while."""
    gc.collect()
    gc.freeze()


class StepClock:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def start(self) -> None:
        if self.cuda:
            self.a.record()
        else:
            self.t = time.perf_counter()

    def stop_ms(self) -> float:
        """Milliseconds since `start`; call once the result is on the
        host (the end event is then the next thing the card runs)."""
        if self.cuda:
            self.b.record()
            self.b.synchronize()
            return float(self.a.elapsed_time(self.b))
        return (time.perf_counter() - self.t) * 1e3


def short_name(name: str) -> str:
    """A kernel's name without 'void ', template arguments or parameters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    for stop in ("<", "("):
        if stop in name:
            name = name[:name.index(stop)]
    return name.strip()[:120] or "unnamed"


def _top(pairs, n=10) -> List[list]:
    sums: Dict[str, float] = {}
    for name, s in pairs:
        sums[name] = sums.get(name, 0.0) + s
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])
            [:n]]


def read_chrome_trace(path: str) -> dict:
    """Device operations, busy seconds and named idle gaps of a trace."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((float(e["ts"]), float(e["dur"]), e.get("name", "")))
        elif cat in HOST_CATS:
            host.append((float(e["ts"]), float(e["dur"]), e.get("name", "")))
    dev.sort()
    host.sort()
    busy, end, gaps = 0.0, None, []
    for ts, dur, name in dev:            # the union of the device's spans
        if end is None or ts >= end:
            if end is not None and ts > end:
                gaps.append((end, ts, name))
            busy += dur
            end = ts + dur
        elif ts + dur > end:
            busy += ts + dur - end
            end = ts + dur
    named = []
    hi = 0
    for g0, g1, nxt in gaps:
        best, label = 0.0, None
        while hi < len(host) and host[hi][0] + host[hi][1] < g0:
            hi += 1
        j = hi
        while j < len(host) and host[j][0] < g1:
            ov = min(g1, host[j][0] + host[j][1]) - max(g0, host[j][0])
            if ov > best:
                best, label = ov, host[j][2]
            j += 1
        if label is None or best < 0.5 * (g1 - g0):
            label = "host, then " + short_name(nxt)
        named.append((label, (g1 - g0) * 1e-6))
    return {"ops": [[n, d * 1e-6] for _, d, n in dev],
            "busy_s": busy * 1e-6,
            "top_ops": _top((short_name(n), d * 1e-6) for _, d, n in dev),
            "top_gaps": _top(named)}


@contextlib.contextmanager
def traced(device):
    """with traced(dev) as out: <steps>  ->  out filled on exit (the
    window's host-clock length and what `read_chrome_trace` gives)."""
    from torch.profiler import ProfilerActivity, profile
    out: dict = {}
    sync(device)
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        sync(device)
        window = time.perf_counter() - t0
        prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="stretto_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        out.update(read_chrome_trace(path))
    finally:
        os.unlink(path)
    out["window_s"] = window
