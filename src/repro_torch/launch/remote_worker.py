"""CLI: serve one engine to RemoteEngineMember clients.

    python -m repro_torch.launch.remote_worker --host 127.0.0.1 \
        --port 9410 --name fast --models sm --sm-ratios 0.8,0.5 \
        --lg-ratios ''

Prints ``DEVICE <torch device>`` (and, on CUDA, the card's name) once
the engine is placed, then ``LISTENING host:port`` once the socket is
bound (port 0 picks a free one — parse the line to learn it), then
serves until interrupted. Launch it with the same model zoo / ladder /
seed as the local EngineSpec it stands in for: the member's scores are
then bit-identical to serving that spec locally on the same device. The
engine runs on `--device` ("cuda" by default; "cpu" runs the plain
kernel versions).
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Sequence


def _ratio_list(text: str) -> List[float]:
    return [float(r) for r in text.split(",") if r.strip() != ""]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Serve one Stretto engine over the wire protocol")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 picks a free port (printed as LISTENING)")
    ap.add_argument("--name", default="remote",
                    help="engine name reported to clients")
    ap.add_argument("--models", default="sm,lg",
                    help="comma-separated planted model names "
                         "(first = sm tier, last = lg tier)")
    ap.add_argument("--sm-ratios", type=_ratio_list, default=[0.8, 0.5, 0.0])
    ap.add_argument("--lg-ratios", type=_ratio_list, default=[0.8, 0.5, 0.3])
    ap.add_argument("--sm-int8", type=_ratio_list, default=[])
    ap.add_argument("--lg-int8", type=_ratio_list, default=[])
    ap.add_argument("--no-cheap", action="store_true",
                    help="drop the non-LLM cheap candidates")
    ap.add_argument("--prefill-batch", type=int, default=16)
    ap.add_argument("--memory-budget-bytes", type=float, default=2e9)
    ap.add_argument("--max-batch", type=int, default=128)
    ap.add_argument("--model-seed", type=int, default=1)
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--kernels", default=None,
                    choices=(None, "auto", "cuda", "ref"))
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (cuda, cpu, cuda:1)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.remote.server import RemoteWorker, start_server
    worker = RemoteWorker(
        args.name,
        models=tuple(m for m in args.models.split(",") if m),
        sm_ratios=tuple(args.sm_ratios), lg_ratios=tuple(args.lg_ratios),
        include_cheap=not args.no_cheap,
        sm_int8=tuple(args.sm_int8), lg_int8=tuple(args.lg_int8),
        prefill_batch=args.prefill_batch,
        memory_budget_bytes=args.memory_budget_bytes,
        max_batch=args.max_batch, model_seed=args.model_seed,
        cache_dir=args.cache_dir, kernels=args.kernels,
        verbose=args.verbose, device=args.device)
    device = worker.engine.device
    if device.type == "cuda":
        import torch
        print(f"DEVICE {device} {torch.cuda.get_device_name(device)}",
              flush=True)
    else:
        print(f"DEVICE {device}", flush=True)
    server, thread, address = start_server(worker, args.host, args.port)
    print(f"LISTENING {address}", flush=True)
    try:
        thread.join()
    except KeyboardInterrupt:
        server.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
