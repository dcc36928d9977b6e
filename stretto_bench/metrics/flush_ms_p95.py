"""flush_ms_p95: the 95th percentile of a flush's latency, in ms.

Each flush is timed with CUDA events from just before the call into the
decode until its log-odds were on the host; the percentile is over every
flush of the window (linear interpolation between order statistics)."""
import numpy as np


def read(run):
    lat = (run.get("window") or {}).get("latency_ms")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat, dtype=np.float64), 95))
