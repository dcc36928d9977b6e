"""Command-line launchers of the port: `remote_worker` (serve one engine
over the wire protocol) and `serve` (concurrent queries through the
QueryScheduler)."""
