"""The work of each hand kernel, and the least time the card could take.

One formula per kernel, whatever runs the call: `chip_smoke.py` prices
each kernel row with it, the op counter (`launch/op_count.py`) counts a
traced call with it, and the dry run's roofline sums it. Bytes are each
input read once and each output written once; flops are what these
inputs need (a decode reads only the cache rows some query row sees):

  A / B  decode: 4 flops per query row per K or V element of a visible
         row; the visible K/V rows, `scale_bytes` per visible (position,
         head) of int8 scales, q and the output, and 4 bytes of length
         per item
  C      Expected-Attention scores: 4 flops per K element (mean_g is
         linear, so the stats reduce over g once, 2 flops per stats
         element); k, mu and sig2 and the float32 scores
  D      prefill: 2 (dk + dv) flops per query row per live key; q, k, v
         and the output

`bound` prices (flops, bytes) against the H100's data-sheet peaks
(`launch/mesh.H100_SXM`): the bf16 tensor cores for 2-byte operands,
67 TFLOP/s float32 outside them for 4-byte ones.

A wrapper that is handed tensors without storage (a `FakeTensor`: the
dry run traces the card's route on them) allocates its outputs, reports
the call here (`report`) and launches nothing; `counting` installs a
sink for those reports.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterable, List

from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.launch.mesh import H100_SXM

PEAK_BYTES_S = H100_SXM.hbm_bw            # H100 SXM HBM3
PEAK_BF16_TC_FLOPS = H100_SXM.flops       # bf16 tensor cores, dense
PEAK_F32_FLOPS = 67e12                    # float32 outside the tensor cores
GLOBAL = 1 << 30


def bound(nbytes: float, flops: float, dtype):
    """(ms, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the flops over the peak rate for the operands' type
    (`dtype.itemsize` 2: the bf16 tensor cores, whose products are exact
    in float32 accumulation; else float32 outside the tensor cores)."""
    peak = PEAK_BF16_TC_FLOPS if dtype.itemsize == 2 else PEAK_F32_FLOPS
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def decode_visible(lengths: Iterable[int], S: int, Lq: int,
                   window: int) -> int:
    """Cache rows some query row sees, summed over the items: positions
    below each item's length inside some row's window."""
    vis = 0
    for n in lengths:
        hi = min(int(n), S)
        lo = max(0, int(n) - Lq - window + 1)
        vis += max(0, hi - lo)
    return vis


def decode_work(B, Lq, KV, G, dk, dv, S, lengths, window, q_itemsize,
                kv_itemsize, scale_bytes=0):
    """(flops, bytes) of one decode call (A with Lq query tokens, B with
    one). `lengths` are numbers (B of them)."""
    vis = decode_visible(lengths, S, Lq, window)
    q_bytes = B * Lq * KV * G * dk * q_itemsize
    nbytes = (vis * KV * ((dk + dv) * kv_itemsize + scale_bytes)
              + q_bytes * (1 + dv / dk) + 4 * B)
    return vis * KV * Lq * G * 2 * (dk + dv), nbytes


def decode_bound(q, k, v, lengths, window, scale_bytes=0):
    """`bound` of a decode call on these tensors (q (B, Lq, KV, G, dk) or
    (B, KV, G, dk)); `lengths` a sequence of numbers."""
    B, Lq, KV, G, dk = q.shape if q.dim() == 5 else \
        (q.shape[0], 1) + tuple(q.shape[1:])
    flops, nbytes = decode_work(B, Lq, KV, G, dk, v.shape[3], v.shape[1],
                                lengths, window, q.element_size(),
                                k.element_size(), scale_bytes)
    return bound(nbytes, flops, q.dtype)


def prefill_live_pairs(S: int, window: int, causal: bool) -> int:
    """(query, key) position pairs the mask admits, per (item, KV head):
    query i sees key j iff i - j < window (and j <= i when causal)."""
    w = min(int(window), GLOBAL)
    if causal:      # sum over i of min(i + 1, w)
        if w >= S:
            return S * (S + 1) // 2
        return w * (w + 1) // 2 + (S - w) * w
    if w >= S:      # sum over i of S - max(0, i - w + 1)
        return S * S
    return S * S - (S - w) * (S - w + 1) // 2


def prefill_work(B, S, KV, G, dk, dv, itemsize, window, causal):
    """(flops, bytes) of one prefill-attention call."""
    nbytes = (B * S * KV * G * dk + B * S * KV * (dk + dv)
              + B * S * KV * G * dv) * itemsize
    return B * KV * G * prefill_live_pairs(S, window, causal) * 2 * (
        dk + dv), nbytes


def prefill_bound(q, k, v, window, causal):
    """`bound` of a prefill call on these tensors, and the time of the
    same flops as float32 FMAs (the FMA body's way)."""
    B, S, KV, G, dk = q.shape
    flops, nbytes = prefill_work(B, S, KV, G, dk, v.shape[-1],
                                 q.element_size(), window, causal)
    return bound(nbytes, flops, q.dtype) + (flops / PEAK_F32_FLOPS * 1e3,)


def expected_attention_work(k_numel, k_itemsize, stats_numel,
                            stats_itemsize, out_numel):
    """(flops, bytes) of one Expected-Attention call: k, mu and sig2 read
    once, the float32 scores written once; priced at the float32 rate."""
    nbytes = (k_numel * k_itemsize + 2 * stats_numel * stats_itemsize
              + out_numel * 4)
    return k_numel * 4 + 2 * stats_numel * 2, nbytes


# ---------------------------------------------------------------------------
# the shape-only route: calls on tensors that have no storage
# ---------------------------------------------------------------------------

_sinks: List[Callable[[str, float, float], None]] = []
_sinks_lock = threading.Lock()


def is_fake(x) -> bool:
    """True for a tensor without storage that a trace runs on."""
    return isinstance(x, FakeTensor)


def report(name: str, flops: float, nbytes: float) -> None:
    """A kernel call on fake tensors: hand its work to every sink."""
    for sink in list(_sinks):
        sink(name, flops, nbytes)


@contextlib.contextmanager
def counting(sink: Callable[[str, float, float], None]):
    """Route `report`s to `sink(name, flops, bytes)` inside."""
    with _sinks_lock:
        _sinks.append(sink)
    try:
        yield
    finally:
        with _sinks_lock:
            _sinks.remove(sink)
