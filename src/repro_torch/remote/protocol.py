"""Wire protocol for remote engine members (the port of
`repro.remote.protocol`, byte for byte on the wire: a port peer and a
reference peer speak to each other).

Frames are length-prefixed binary messages over a stream socket:

    magic "SW" (2B) | version (1B) | flags (1B) | payload length (4B, BE)

followed by the payload: a msgpack- or JSON-encoded dict (flag bit 1),
optionally zlib-compressed (flag bit 0) when the raw payload crosses
`COMPRESS_MIN` bytes. JSON is the floor every peer must speak — msgpack
is used only when both sides import it (negotiated by the `hello`
handshake), never required, so the protocol works on a bare stdlib.

Numeric fidelity: scores are float32 on both ends. Python's float repr
round-trips exactly through JSON (and msgpack carries IEEE doubles), and
float32 -> float64 -> float32 is lossless, so a remote member's scores
are bit-identical to scoring locally — the parity guarantee the whole
subsystem is pinned on.

Message verbs (all dicts with a "verb" key; responses carry "ok"):

  hello        — protocol/version + encoding negotiation
  sync         — corpus sync: (item_id, tokens) pairs + corpus hash; the
                 worker builds its profiles lazily on the first sync and
                 echoes the hash back (the data handshake)
  catalog      — the worker's operator ladder for one op kind
  score_filter — batched filter scoring by item ids (or pair ids)
  run_map      — batched map extraction by item ids
  warm / evict — device-LRU staging, forwarded to the worker's engine
  health       — liveness + uptime + synced corpus hash
  stats        — the worker's request counters

Scoring responses return the member's telemetry deltas (kv_bytes,
attn_dispatches, h2d_overlap_s, donated_bytes, server_wall_s) so the
client can keep per-engine StageStats exact end to end.
"""
from __future__ import annotations

import hashlib
import json
import struct
import zlib
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.logical import (SemAgg, SemFilter, SemJoin, SemMap,
                                      SemTopK)

try:                                    # optional — JSON is the floor
    import msgpack                      # type: ignore
    HAVE_MSGPACK = True
except ImportError:                     # pragma: no cover - env dependent
    msgpack = None
    HAVE_MSGPACK = False

PROTOCOL_VERSION = 1
MAGIC = b"SW"
FLAG_ZLIB = 0x01
FLAG_MSGPACK = 0x02
HEADER = struct.Struct(">2sBBI")
COMPRESS_MIN = 8192                     # compress payloads past this size
MAX_FRAME = 512 * 1024 * 1024           # hard cap against garbage lengths


class ProtocolError(RuntimeError):
    """Malformed frame, version mismatch, or truncated stream."""


# ---------------- frame codec ----------------

def encode_frame(obj: Dict[str, Any], *, encoding: str = "json") -> bytes:
    """One wire frame for `obj`. `encoding` is "json" or "msgpack" (the
    latter requires the msgpack import — negotiate via `hello` first)."""
    flags = 0
    if encoding == "msgpack":
        if not HAVE_MSGPACK:
            raise ProtocolError("msgpack encoding requested but msgpack "
                                "is not installed")
        payload = msgpack.packb(obj, use_bin_type=True)
        flags |= FLAG_MSGPACK
    elif encoding == "json":
        payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    else:
        raise ProtocolError(f"unknown frame encoding {encoding!r}")
    if len(payload) >= COMPRESS_MIN:
        packed = zlib.compress(payload, 1)
        if len(packed) < len(payload):
            payload = packed
            flags |= FLAG_ZLIB
    return HEADER.pack(MAGIC, PROTOCOL_VERSION, flags, len(payload)) \
        + payload


def decode_frame(header: bytes, payload: bytes
                 ) -> Tuple[Dict[str, Any], str]:
    """Decode one frame; returns (message, encoding-name)."""
    magic, version, flags, _ = HEADER.unpack(header)
    if magic != MAGIC:
        raise ProtocolError(f"bad frame magic {magic!r}")
    if version != PROTOCOL_VERSION:
        raise ProtocolError(
            f"protocol version mismatch: peer speaks {version}, "
            f"this side speaks {PROTOCOL_VERSION}")
    if flags & FLAG_ZLIB:
        payload = zlib.decompress(payload)
    if flags & FLAG_MSGPACK:
        if not HAVE_MSGPACK:
            raise ProtocolError("received a msgpack frame but msgpack is "
                                "not installed on this side")
        return msgpack.unpackb(payload, raw=False), "msgpack"
    return json.loads(payload.decode("utf-8")), "json"


def _recv_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ProtocolError(
                f"connection closed mid-frame ({len(buf)}/{n} bytes)")
        buf.extend(chunk)
    return bytes(buf)


def send_msg(sock, obj: Dict[str, Any], *, encoding: str = "json") -> int:
    """Send one frame; returns bytes put on the wire."""
    frame = encode_frame(obj, encoding=encoding)
    sock.sendall(frame)
    return len(frame)


def recv_msg(sock) -> Tuple[Optional[Dict[str, Any]], str, int]:
    """Receive one frame: (message, encoding, wire bytes). Returns
    (None, "", 0) on a clean EOF at a frame boundary."""
    try:
        first = sock.recv(1)
    except ConnectionResetError:
        return None, "", 0
    if not first:
        return None, "", 0
    header = first + _recv_exact(sock, HEADER.size - 1)
    length = HEADER.unpack(header)[3]
    if length > MAX_FRAME:
        raise ProtocolError(f"frame length {length} exceeds cap "
                            f"{MAX_FRAME}")
    payload = _recv_exact(sock, length) if length else b""
    msg, encoding = decode_frame(header, payload)
    return msg, encoding, HEADER.size + length


# ---------------- semantic-operator codec ----------------

def sem_to_wire(op) -> Dict[str, Any]:
    """Serialize a frozen semantic-operator dataclass by kind + fields.
    Subclass checks come first: SemTopK is a SemFilter, SemAgg a SemMap."""
    if isinstance(op, SemTopK):
        return {"kind": "topk", "text": op.text, "task_id": op.task_id,
                "modality": op.modality, "k": op.k}
    if isinstance(op, SemAgg):
        return {"kind": "agg", "text": op.text, "task_id": op.task_id,
                "out_column": op.out_column, "modality": op.modality,
                "group_by": op.group_by, "how": op.how}
    if isinstance(op, SemJoin):
        return {"kind": "join", "text": op.text, "task_id": op.task_id,
                "on": op.on, "modality": op.modality}
    if isinstance(op, SemMap):
        return {"kind": "map", "text": op.text, "task_id": op.task_id,
                "out_column": op.out_column, "modality": op.modality}
    if isinstance(op, SemFilter):
        return {"kind": "filter", "text": op.text, "task_id": op.task_id,
                "modality": op.modality}
    raise ProtocolError(f"cannot serialize semantic op {op!r}")


def sem_from_wire(d: Dict[str, Any]):
    kind = d.get("kind")
    if kind == "topk":
        return SemTopK(d["text"], d["task_id"], modality=d["modality"],
                       k=d["k"])
    if kind == "agg":
        return SemAgg(d["text"], d["task_id"], out_column=d["out_column"],
                      modality=d["modality"], group_by=d["group_by"],
                      how=d["how"])
    if kind == "join":
        return SemJoin(d["text"], d["task_id"], on=d["on"],
                       modality=d["modality"])
    if kind == "map":
        return SemMap(d["text"], d["task_id"], out_column=d["out_column"],
                      modality=d["modality"])
    if kind == "filter":
        return SemFilter(d["text"], d["task_id"], modality=d["modality"])
    raise ProtocolError(f"unknown semantic op kind {kind!r}")


# ---------------- corpus hash (the data handshake) ----------------

def corpus_hash(pairs: Iterable[Tuple[int, Sequence[int]]]) -> str:
    """Order-independent fingerprint of a corpus as (item_id, tokens)
    pairs — platform-stable (fixed-width big-endian packing), so a
    client and a worker on different hosts agree on the data."""
    h = hashlib.sha1()
    for item_id, tokens in sorted((int(i), tuple(int(t) for t in ts))
                                  for i, ts in pairs):
        h.update(struct.pack(">qI", item_id, len(tokens)))
        h.update(struct.pack(f">{len(tokens)}q", *tokens))
    return h.hexdigest()


def items_to_wire(items: Sequence[Any]) -> List[List[Any]]:
    """Corpus items as [item_id, [tokens...]] pairs (the only fields
    operators consume on the worker side)."""
    out = []
    for it in items:
        item_id = getattr(it, "item_id", None)
        tokens = getattr(it, "tokens", None)
        if item_id is None or tokens is None:
            raise ProtocolError(
                "remote corpus sync needs items with `item_id` and "
                f"`tokens`; got {type(it).__name__}")
        out.append([int(item_id), [int(t) for t in tokens]])
    return out
