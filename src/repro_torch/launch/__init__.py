"""Command-line launchers of the port: `remote_worker` (serve one engine
over the wire protocol), `serve` (concurrent queries through the
QueryScheduler), `train` (the training loop) and `dryrun` (every
(arch x shape) cell reckoned for a pod of H100s, with no card); `specs`
holds the shape stand-ins and shardings of each cell, `mesh` the meshes
and the hardware peak sets, `op_count` the op counter a dry run traces
under."""
