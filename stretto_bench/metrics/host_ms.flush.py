"""host_ms.flush: the host's milliseconds to enqueue one flush.

From the call into the decode (the query tokens' copy included) until it
returns, before the log-odds are read back: the Python that dispatches
a flush. Summed over every flush of the window, over the flushes."""


def read(run):
    host = (run.get("window") or {}).get("host_s")
    if not host:
        return None
    return 1e3 * sum(host) / len(host)
