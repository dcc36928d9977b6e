"""prefill_tokens_per_s: live document tokens prefilled and scored over
the window; the padding of a chunk to its longest prompt is not counted."""


def read(run):
    w = run.get("window") or {}
    if "tokens" not in w:
        return None
    return w["tokens"] / w["seconds"]
