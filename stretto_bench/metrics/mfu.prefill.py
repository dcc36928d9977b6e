"""mfu.prefill: the flops the window's live tokens need, over the window
(host clock) and 989 TFLOP/s, in %.

`cost.prefill_step_work` per chunk: each item's products and causal
attention over its own length, the head at its last position, kernel C
over its live rows; the padding of the chunk is not work."""
from stretto_bench import cost


def read(run):
    w = run.get("window") or {}
    if "chunks" not in w or not w["chunks"]:
        return None
    flops = sum(cost.prefill_step_work(run["model"], ls)[0]
                for ls in w["chunks"])
    return 100.0 * flops / w["seconds"] / cost.PEAK_BF16_FLOPS
