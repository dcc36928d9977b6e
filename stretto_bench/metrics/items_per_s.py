"""items_per_s: documents the gold operator decided, over the window.

Every flush of the window decides each of its documents once; the rate is
all of them over all of the window's host-clock seconds."""


def read(run):
    w = run.get("window") or {}
    if "items" not in w:
        return None
    return w["items"] / w["seconds"]
