"""idle.prefill: the share of the traced prefill window with no operation
running on the card, in %."""


def read(run):
    tr = run.get("trace")
    if not tr or "chunks" not in tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
