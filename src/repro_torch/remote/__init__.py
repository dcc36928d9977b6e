"""Remote engine members: any EngineSpec behind a wire protocol (the port
of `repro.remote`; its frames are the reference's, so port and reference
peers serve each other).

The subsystem has three layers plus an integration seam:

  protocol — versioned, length-prefixed msgpack-or-JSON frames for
      score_filter / run_map / warm / evict / health / stats, carrying
      operator identity, a compression tag, item batches, and the
      member's per-call telemetry deltas (kv_bytes, attn_dispatches,
      h2d_overlap_s, donated_bytes) so per-engine StageStats stay exact
      end to end.
  server — a threaded socket server (RemoteWorker) wrapping one local
      ServingEngine + KVCacheBackend on its device ("cuda" by default),
      building profiles lazily on the first corpus sync, with a
      corpus-hash handshake so client and worker agree on data.
      `launch/remote_worker.py` is the CLI.
  client — RemoteEngineMember, a pool member whose score_filter /
      run_map go over the wire: per-call timeouts, exponential-backoff
      retries on idempotent calls, a circuit breaker after K consecutive
      failures, and a degradation policy (`on_unavailable="fallback"`
      re-routes failed calls to the gold/local engine mid-run and
      records it; `"fail"` raises RemoteEngineError).

Declared as ``EngineSpec(address="host:port")`` in a SessionConfig, a
remote member routes through PoolBackend transparently, FlushHub merges
cross-query flushes destined for it into one wire call, and EXPLAIN
ANALYZE renders a "remote:" footer (calls, retries, fallbacks, rtt_ms
p50/p95, wire bytes).
"""
from repro_torch.remote.client import (RemoteEngineError, RemoteEngineMember,
                                       remote_members, remote_run_info)
from repro_torch.remote.protocol import PROTOCOL_VERSION, ProtocolError
from repro_torch.remote.server import RemoteWorker, start_server

__all__ = [
    "PROTOCOL_VERSION",
    "ProtocolError",
    "RemoteEngineError",
    "RemoteEngineMember",
    "RemoteWorker",
    "remote_members",
    "remote_run_info",
    "start_server",
]
