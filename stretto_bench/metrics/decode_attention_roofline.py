"""decode_attention_roofline: kernel A's share of its roofline, in %.

Kernel A is `csrc/decode_attention.cu` (`split_kernel`), launched once per
layer per flush. Its least time per call is `cost.decode_work` at the
flush's shapes (every item's cached rows and its query's own row, read
once); its time is the traced kernels' device time."""
from stretto_bench import cost

KERNELS = ("split_kernel",)


def read(run):
    tr, w, m = run.get("trace"), run.get("window") or {}, run["model"]
    if not tr or "lengths" not in w or "kv_lora_rank" in m:
        return None
    secs = sum(s for name, s in tr["ops"]
               if any(k in name for k in KERNELS))
    if secs <= 0:
        return None
    d = cost.dims(m)
    B = len(w["lengths"])
    flops, nbytes = cost.decode_work(
        B, 1, d["KV"], d["H"] // d["KV"], d["dh"], d["dh"], w["S"],
        [n + 1 for n in w["lengths"]], cost.GLOBAL, 2, 2)
    least, _ = cost.bound_s(nbytes, flops)
    calls = tr["steps"] * d["L"]
    return 100.0 * calls * least / secs
