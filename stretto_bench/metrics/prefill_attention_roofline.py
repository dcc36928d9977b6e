"""prefill_attention_roofline: kernel D's share of its roofline, in %.

Kernel D is `csrc/prefill_attention_tc.cu` (`prefill_tc_kernel`; the
float32 body `prefill_kernel` of `csrc/prefill_attention.cu` counts too),
launched once per layer per chunk over the chunk's padded prompts. Its
least time per call is `cost.prefill_work` at the chunk's shapes (causal,
every padded position, as the call is asked for); its time is the traced
kernels' device time."""
from stretto_bench import cost

KERNELS = ("prefill_tc_kernel", "prefill_kernel")


def read(run):
    tr, m = run.get("trace"), run["model"]
    if not tr or "chunks" not in tr or "kv_lora_rank" in m:
        return None
    secs = sum(s for name, s in tr["ops"]
               if any(k in name for k in KERNELS))
    if secs <= 0:
        return None
    d = cost.dims(m)
    least = 0.0
    for ls, S in zip(tr["chunks"], tr["S"]):
        flops, nbytes = cost.prefill_work(
            len(ls), S, d["KV"], d["H"] // d["KV"], d["dh"], d["dh"], 2,
            cost.GLOBAL, True)
        least += d["L"] * cost.bound_s(nbytes, flops)[0]
    return 100.0 * least / secs
