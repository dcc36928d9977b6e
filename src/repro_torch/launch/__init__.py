"""Command-line launchers of the port: `remote_worker` (serve one engine
over the wire protocol), `serve` (concurrent queries through the
QueryScheduler) and `train` (the training loop); `specs` holds the shape
stand-ins and shardings of each (arch x shape) cell."""
