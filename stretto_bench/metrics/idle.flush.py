"""idle.flush: the share of the measured window with no operation running
on the card, in %.

A flush launches some hundreds to thousands of small operations, and the
profiler's runtime tracing slows the host's launches by tens of percent,
so the traced window's own idle share overstates the untraced one. The
device time of a flush is read from the trace (kernel durations are
device timestamps, which tracing leaves alone) and set against the mean
flush of the untraced window: 1 - busy per traced flush / window per
flush."""


def read(run):
    tr, w = run.get("trace"), run.get("window") or {}
    if not tr or "items" not in w or not tr.get("steps"):
        return None
    busy = tr["busy_s"] / tr["steps"]
    return 100.0 * (1.0 - busy / (w["seconds"] / w["steps"]))
