"""mfu.flush: a flush's share of the card's peak by its roofline, in %.

The least time of one flush, the larger of its flops over 989 TFLOP/s
and its bytes over 3.35 TB/s (`cost.decode_step_work`: the weights the
live rows need, MoE experts as uniform routing's expectation, the head,
the live cache rows), over the mean flush of the window (host clock,
all flushes). Decode at these lengths is bound by its bytes."""
from stretto_bench import cost


def read(run):
    w = run.get("window") or {}
    if "lengths" not in w or not w.get("steps"):
        return None
    flops, nbytes = cost.decode_step_work(run["model"], w["lengths"])
    least, _ = cost.bound_s(nbytes, flops)
    return 100.0 * least / (w["seconds"] / w["steps"])
