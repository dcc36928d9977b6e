"""Remote engine members in the port (twins of `tests/test_remote.py`), and
the wire between port and reference peers.

Protocol — frames round-trip (JSON floor, zlib past the compression
threshold, msgpack when both peers import it), version/magic mismatches
raise ProtocolError, a clean EOF at a frame boundary is told apart from
a mid-frame truncation, semantic operators keep their exact subclass,
and the corpus hash is order-independent. The constants and encodings
are the reference's: a frame one package encodes, the other decodes.

Validation — a remote EngineSpec is checked at construction (malformed
addresses, address + device / dispatcher affinity, unknown policies,
non-positive timeouts, negative retries, a remote gold engine). A spec's
`device` defaults to None, which a local engine resolves to "cuda".

Parity — a port pool with one member served by an in-process port
worker on 127.0.0.1 (device="cpu") gives the all-local pool's catalog
(names, gold flags, costs), bit-equal scores for every operator, and,
for one hand-set plan (first stages on "fast", gold on "accurate"),
bit-equal decisions, map values and integer StageStats (kv_bytes
included) under inline and threads:2, solo and through the scheduler,
where merged flushes reach the wire as fewer calls. The plan is set by
hand: which stages a planner keeps depends on measured wall times, so a
planned plan could drop the remote stages and make the check vacuous.

Robustness — a real `--device cpu` worker subprocess, SIGKILLed mid-run:
"fallback" completes on the gold engine with fallbacks > 0; "fail"
raises RemoteEngineError and leaves the session usable. Application
errors are never masked; the circuit breaker fails fast.

Wire compatibility — a port member against a reference (JAX) worker and
a reference member against a port worker, both serving the planted "sm"
model: handshake, echoed corpus hash, catalog names and flags, and
scores within ATOL of the other package's own local scores, with
decisions (the sign of the log-odds) equal outside MARGIN.
"""
import math
import os
import signal
import socket

import numpy as np
import pytest

import repro.remote as jremote
from repro.core import logical as jlogical
from repro.data import synthetic as jsyn
from repro.remote import protocol as jproto
from repro_torch.api import EngineSpec, Session, SessionConfig
from repro_torch.api.result import QueryResult
from repro_torch.core import PlannerConfig
from repro_torch.core import logical as tlogical
from repro_torch.core.logical import (Query, SemAgg, SemFilter, SemJoin,
                                      SemMap, SemTopK)
from repro_torch.core.physical import PhysicalPlan, PhysicalPlanStage
from repro_torch.remote import (RemoteEngineError, RemoteEngineMember,
                                RemoteWorker, start_server)
from repro_torch.remote import protocol as proto
from repro_torch.remote.client import remote_members, remote_run_info
from repro_torch.remote.testing import spawn_worker, worker_argv
from repro_torch.runtime import gold_plan_for
from repro_torch.scheduler import QueryScheduler

FAST = PlannerConfig(steps=120, restarts=2, snapshots=2)
N_ITEMS = 90
# the worker's identity — the local "fast" spec and every worker in this
# module use exactly these values, which is what makes scores bit-equal
FAST_SPEC = dict(models=("sm",), sm_ratios=(0.8, 0.5), lg_ratios=())
ATOL = 1e-4        # planted scores, port vs JAX (test_torch_cache_engine)
MARGIN = 1e-3      # decisions compared outside this band of a threshold

QUERY = Query([SemFilter("f1", 1), SemMap("extract v2", 2)])
# filter: fast sm-kv80 -> accurate lg-kv50 -> gold; map: fast sm-kv50 ->
# gold (thresholds as chip_smoke.py's planted plan)
HAND_STAGES = [(0, 0, "fast/sm-kv80", 2.5, -3.0, False, False, "fast"),
               (1, 0, "fast/sm-kv50", 1.5, -math.inf, True, False, "fast"),
               (0, 1, "accurate/lg-kv50", 3.0, -4.0, False, False,
                "accurate"),
               (0, 2, "accurate/lg-kv00", 0.0, 0.0, False, True, "accurate"),
               (1, 1, "accurate/lg-kv00", 0.0, 0.0, True, True, "accurate")]


def hand_plan() -> PhysicalPlan:
    return PhysicalPlan(
        [PhysicalPlanStage(li, st, op, hi, lo, is_map, gold, 0.1,
                           engine=eng)
         for li, st, op, hi, lo, is_map, gold, eng in HAND_STAGES],
        [], 0.0, 1.0, 1.0, True)


# ---------------------------------------------------------------------------
# protocol units (no worker)
# ---------------------------------------------------------------------------

def test_protocol_constants_are_the_reference_wire():
    assert (proto.PROTOCOL_VERSION, proto.MAGIC, proto.HEADER.format,
            proto.COMPRESS_MIN, proto.MAX_FRAME, proto.FLAG_ZLIB,
            proto.FLAG_MSGPACK) == (
        jproto.PROTOCOL_VERSION, jproto.MAGIC, jproto.HEADER.format,
        jproto.COMPRESS_MIN, jproto.MAX_FRAME, jproto.FLAG_ZLIB,
        jproto.FLAG_MSGPACK) == (1, b"SW", ">2sBBI", 8192, 512 << 20, 1, 2)


@pytest.mark.parametrize("encoding", ["json", "msgpack"])
def test_frames_cross_between_packages(encoding):
    if encoding == "msgpack" and not proto.HAVE_MSGPACK:
        pytest.skip("msgpack not installed")
    big = {"verb": "sync", "items": [[i, list(range(40))]
                                     for i in range(300)],
           "scores": [0.1, -2.5e-8, 3.0]}
    for enc, dec in ((proto, jproto), (jproto, proto)):
        frame = enc.encode_frame(big, encoding=encoding)
        assert frame == (jproto if enc is proto else proto).encode_frame(
            big, encoding=encoding)
        msg, got = dec.decode_frame(frame[:dec.HEADER.size],
                                    frame[dec.HEADER.size:])
        assert msg == big and got == encoding


def test_frame_roundtrip_json_and_zlib():
    small = {"verb": "health", "n": 3, "xs": [1.5, -2.25]}
    frame = proto.encode_frame(small)
    msg, enc = proto.decode_frame(frame[:proto.HEADER.size],
                                  frame[proto.HEADER.size:])
    assert msg == small and enc == "json"
    big = {"verb": "sync", "items": [[i, list(range(40))]
                                     for i in range(300)]}
    frame = proto.encode_frame(big)
    flags = proto.HEADER.unpack(frame[:proto.HEADER.size])[2]
    assert flags & proto.FLAG_ZLIB
    assert len(frame) < len(str(big))
    msg, _ = proto.decode_frame(frame[:proto.HEADER.size],
                                frame[proto.HEADER.size:])
    assert msg == big


def test_frame_rejects_bad_version_and_magic():
    payload = b"{}"
    bad_ver = proto.HEADER.pack(proto.MAGIC, proto.PROTOCOL_VERSION + 1,
                                0, len(payload))
    with pytest.raises(proto.ProtocolError, match="version"):
        proto.decode_frame(bad_ver, payload)
    bad_magic = proto.HEADER.pack(b"XX", proto.PROTOCOL_VERSION,
                                  0, len(payload))
    with pytest.raises(proto.ProtocolError, match="magic"):
        proto.decode_frame(bad_magic, payload)
    with pytest.raises(proto.ProtocolError, match="encoding"):
        proto.encode_frame({}, encoding="bson")


def test_send_recv_eof_vs_truncation():
    a, b = socket.socketpair()
    try:
        proto.send_msg(a, {"verb": "health"})
        msg, enc, nbytes = proto.recv_msg(b)
        assert msg == {"verb": "health"} and enc == "json" and nbytes > 0
        a.close()
        assert proto.recv_msg(b) == (None, "", 0)
    finally:
        b.close()
    a, b = socket.socketpair()
    try:
        frame = proto.encode_frame({"verb": "stats"})
        a.sendall(frame[:proto.HEADER.size + 1])
        a.close()
        with pytest.raises(proto.ProtocolError, match="mid-frame"):
            proto.recv_msg(b)
    finally:
        b.close()


def test_sem_codec_roundtrips_exact_subclass():
    ops = (SemFilter("f", 1), SemFilter("f", 1, modality="image"),
           SemMap("m", 2, out_column="v"), SemTopK("t", 3, k=5),
           SemAgg("a", 4, group_by="g", how="mode"),
           SemJoin("j", 5, on="col"))
    for op in ops:
        back = proto.sem_from_wire(proto.sem_to_wire(op))
        assert type(back) is type(op)
        assert back == op
        # the reference's codec writes the same dict
        assert jproto.sem_to_wire(jproto.sem_from_wire(
            proto.sem_to_wire(op))) == proto.sem_to_wire(op)
    with pytest.raises(proto.ProtocolError):
        proto.sem_to_wire(object())
    with pytest.raises(proto.ProtocolError):
        proto.sem_from_wire({"kind": "reduce"})


def test_corpus_hash_order_independent_and_the_references():
    pairs = [(1, (3, 4, 5)), (2, (6, 7)), (3, ())]
    h = proto.corpus_hash(pairs)
    assert h == jproto.corpus_hash(pairs)
    assert proto.corpus_hash(reversed(pairs)) == h
    assert proto.corpus_hash([(1, (3, 4, 9)), (2, (6, 7)), (3, ())]) != h
    assert proto.corpus_hash([(1, (3, 4, 5)), (2, (6, 7))]) != h
    with pytest.raises(proto.ProtocolError, match="item_id"):
        proto.items_to_wire([{"not": "an item"}])


# ---------------------------------------------------------------------------
# config validation
# ---------------------------------------------------------------------------

def test_engine_spec_remote_validation():
    ok = EngineSpec("r", address="127.0.0.1:9410")
    assert ok.on_unavailable == "fallback" and ok.device is None
    assert EngineSpec("local").device is None      # resolves to "cuda"
    with pytest.raises(ValueError, match="host:port"):
        EngineSpec("r", address="no-port-here")
    for dev in (0, "cpu", "cuda"):
        with pytest.raises(ValueError, match="device"):
            EngineSpec("r", address="127.0.0.1:9410", device=dev)
    with pytest.raises(ValueError, match="dispatcher"):
        EngineSpec("r", address="127.0.0.1:9410", dispatcher=2)
    with pytest.raises(ValueError, match="on_unavailable"):
        EngineSpec("r", address="127.0.0.1:9410", on_unavailable="retry")
    with pytest.raises(ValueError, match="timeout_s"):
        EngineSpec("r", address="127.0.0.1:9410", timeout_s=0.0)
    with pytest.raises(ValueError, match="remote_retries"):
        EngineSpec("r", address="127.0.0.1:9410", remote_retries=-1)


def test_remote_gold_engine_rejected():
    with pytest.raises(ValueError, match="gold"):
        SessionConfig(engines=(EngineSpec("r", address="127.0.0.1:9410"),))
    with pytest.raises(ValueError, match="gold"):
        SessionConfig(
            engines=(EngineSpec("local"),
                     EngineSpec("r", address="127.0.0.1:9410")),
            gold_engine="r")
    cfg = SessionConfig(
        engines=(EngineSpec("r", address="127.0.0.1:9410"),
                 EngineSpec("local")),
        gold_engine="local")
    assert cfg.resolved_engines()[0].address is not None


def test_member_and_worker_constructor_validation(tmp_path):
    with pytest.raises(ValueError, match="host:port"):
        RemoteEngineMember("x", "nohost")
    with pytest.raises(ValueError, match="on_unavailable"):
        RemoteEngineMember("x", "127.0.0.1:9410", on_unavailable="punt")
    with pytest.raises(ValueError, match="kernels"):
        RemoteWorker("x", kernels="pallas", device="cpu",
                     cache_dir=str(tmp_path), **FAST_SPEC)
    argv = worker_argv(name="w", **FAST_SPEC)
    assert argv[1:3] == ["-m", "repro_torch.launch.remote_worker"]
    assert "--device" not in argv                  # the worker's default
    assert worker_argv(device="cpu")[-2:] == ["--device", "cpu"]


def test_warm_evict_noop_on_unbuilt_rungs(tmp_path):
    worker = RemoteWorker("noop", cache_dir=str(tmp_path), device="cpu",
                          **FAST_SPEC)
    eng = worker.engine
    eng.device_cache = True            # the LRU these verbs stage into
    assert eng.warm("sm", 0.5, [1, 2, 3]) == 0
    assert eng.warm("sm", 0.5, []) == 0
    assert eng.warm("unknown-model", 0.5, [1]) == 0
    assert eng.evict() == 0
    assert eng.evict("sm", 0.5) == 0
    assert worker.handle({"verb": "warm", "model": "sm", "ratio": 0.5}) \
        == {"ok": True, "batches": 0}
    assert worker.handle({"verb": "evict", "model": None, "ratio": None}) \
        == {"ok": True, "dropped": 0}
    assert worker.handle({"verb": "nope"})["etype"] == "ProtocolError"
    items = jsyn.make_dataset("warm", 12, seed=1).items
    eng.build_profiles("sm", items[:6], ratios=[0.5], prefill_batch=4)
    all_ids = [it.item_id for it in items]
    assert eng.warm("sm", 0.5, all_ids) >= 1
    assert eng.warm("sm", 0.8, all_ids) == 0
    assert eng.evict("sm", 0.8) == 0


# ---------------------------------------------------------------------------
# loopback world: one in-process port worker + the local twin of its spec
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    ds = jsyn.make_dataset("remote", N_ITEMS, seed=7)
    worker = RemoteWorker(
        "fast", cache_dir=str(tmp_path_factory.mktemp("worker")),
        device="cpu", **FAST_SPEC)
    server, _, addr = start_server(worker)
    yield ds, worker, addr
    server.shutdown()
    server.server_close()


def _accurate(tmp_path_factory, tag):
    return EngineSpec("accurate", models=("lg",), sm_ratios=(),
                      lg_ratios=(0.5,), include_cheap=False, device="cpu",
                      cache_dir=str(tmp_path_factory.mktemp(tag)))


def _session(tmp_path_factory, fast_spec, tag):
    return Session(SessionConfig(
        engines=(fast_spec, _accurate(tmp_path_factory, tag)),
        gold_engine="accurate", planner=FAST, sample_frac=0.35,
        partition_size=40))


@pytest.fixture(scope="module")
def sessions(world, tmp_path_factory):
    ds, _, addr = world
    local = _session(
        tmp_path_factory,
        EngineSpec("fast", cache_dir=str(tmp_path_factory.mktemp("fl")),
                   device="cpu", **FAST_SPEC), "al")
    remote = _session(tmp_path_factory,
                      EngineSpec("fast", address=addr), "ar")
    local.prepare(ds.items)
    remote.prepare(ds.items)
    yield ds, local, remote
    local.close()
    remote.close()


def _same(a, b):
    np.testing.assert_array_equal(a.accepted, b.accepted)
    assert set(a.map_values) == set(b.map_values)
    for li in b.map_values:
        np.testing.assert_array_equal(a.map_values[li], b.map_values[li])


def _ints(r):
    key = lambda sg: (sg.logical_idx, sg.stage, sg.op_name)
    return {key(sg): (sg.engine, sg.n_tuples, sg.n_llm_calls, sg.n_batches,
                      sg.kv_bytes) for sg in r.stage_stats}


def test_session_builds_no_local_engine_for_remote_spec(sessions):
    ds, local, remote = sessions
    assert set(local.engines) == {"fast", "accurate"}
    assert set(remote.engines) == {"accurate"}          # no local slot
    assert remote.engine is remote.engines["accurate"]
    members = remote_members(remote.backend)
    assert [m.engine_name for m in members] == ["fast"]
    assert remote.backend.members["fast"] is members[0]
    with pytest.raises(ValueError, match="remote"):
        remote.backend_for(engine="fast")
    h = members[0].health()
    assert h["ok"] and h["n_items"] == len(ds.items)
    assert h["corpus_hash"] == members[0]._synced_hash == proto.corpus_hash(
        (it.item_id, it.tokens) for it in ds.items)


def test_catalog_matches_local_candidates(sessions):
    ds, local, remote = sessions
    for op in (SemFilter("f1", 1), SemMap("extract v2", 2)):
        lc = local.backend.candidates(op)
        rc = remote.backend.candidates(op)
        assert [c.name for c in rc] == [c.name for c in lc]
        assert [c.is_gold for c in rc] == [c.is_gold for c in lc]
        assert [c.cost_model() for c in rc] == [c.cost_model() for c in lc]
        assert [getattr(c, "engine_name", None) for c in rc] \
            == [getattr(c, "engine_name", None) for c in lc]
    assert {s[2] for s in HAND_STAGES} <= {
        c.name for c in local.backend.candidates(QUERY.nodes[0])}


def test_every_fast_operator_scores_bit_identically(sessions):
    ds, local, remote = sessions
    op = SemFilter("f1", 1)
    batch = ds.items[:32]
    for cand in local.backend.candidates(op):
        ls = local.backend.score_filter(op, cand.name, batch)
        rs = remote.backend.score_filter(op, cand.name, batch)
        np.testing.assert_array_equal(rs, ls)
        assert rs.dtype == np.float32
    mop = SemMap("extract v2", 2)
    for cand in local.backend.candidates(mop):
        lv, lcf = local.backend.run_map(mop, cand.name, batch)
        rv, rcf = remote.backend.run_map(mop, cand.name, batch)
        np.testing.assert_array_equal(rv, lv)
        np.testing.assert_array_equal(rcf, lcf)


@pytest.mark.parametrize("dispatcher", ["inline", "threads:2"])
def test_same_plan_parity_local_vs_remote(sessions, dispatcher):
    """One hand-set plan, two pools (one wired through the loopback
    worker): decisions, map values and per-engine integer StageStats
    bit-identical, the remote run's wire telemetry showing real calls
    and no fallback."""
    ds, local, remote = sessions
    plan = hand_plan()
    lr = local.run(plan, QUERY, ds.items, dispatcher=dispatcher)
    rr = remote.run(plan, QUERY, ds.items, dispatcher=dispatcher)
    _same(rr, lr)
    assert _ints(rr) == _ints(lr)
    assert {e for e, *_ in _ints(rr).values()} == {"fast", "accurate"}
    assert any(v[4] for k, v in _ints(rr).items() if v[0] == "fast")
    assert lr.remote is None                 # all-local run: no footer
    assert rr.remote is not None
    assert rr.remote["calls"] > 0
    assert rr.remote["fallbacks"] == 0 and rr.remote["errors"] == 0
    assert set(rr.remote["engines"]) == {"fast"}
    assert rr.remote["rtt_ms_p95"] >= rr.remote["rtt_ms_p50"] >= 0.0


def test_explain_analyze_wire_footer(sessions):
    ds, local, remote = sessions
    plan = hand_plan()
    rres = QueryResult(remote, QUERY, ds.items,
                       remote.run(plan, QUERY, ds.items,
                                  dispatcher="inline"))
    text = rres.explain_analyze().render()
    assert "remote: calls=" in text and "rtt_ms p50=" in text
    assert "remote fast: calls=" in text and "fallbacks=0" in text
    lres = QueryResult(local, QUERY, ds.items,
                       local.run(plan, QUERY, ds.items, dispatcher="inline"))
    assert "remote:" not in lres.explain_analyze().render()


def test_remote_session_plans_through_the_wire_catalog(sessions):
    """Planning profiles the remote operators over the wire; the plan is
    placed on pool engines (which stages it keeps rests on measured wall
    times, so no stage set is asserted)."""
    ds, _, remote = sessions
    member = remote_members(remote.backend)[0]
    before = member.snapshot()["calls"]
    plan = remote.plan(QUERY, ds.items)
    assert member.snapshot()["calls"] > before       # profiling calls
    assert all(st.engine in ("fast", "accurate") for st in plan.stages)
    assert all(st.engine == "accurate" for st in plan.stages if st.is_gold)


def test_scheduler_coalesces_remote_wire_calls(sessions):
    """K concurrent copies of the hand plan through the QueryScheduler:
    each bit-identical to solo, with solo's integer StageStats, and the
    hub's merged groups reach the wire as fewer calls than K solo runs."""
    ds, _, remote = sessions
    member = remote_members(remote.backend)[0]
    plan = hand_plan()
    before = member.snapshot()
    solo = remote.run(plan, QUERY, ds.items, dispatcher="inline")
    solo_calls = member.snapshot()["calls"] - before["calls"]
    assert solo_calls > 0
    K = 3
    before = member.snapshot()
    with QueryScheduler(remote, max_concurrent=K, paused=True) as sched:
        handles = [sched.submit(query=QUERY, items=ds.items, plan=plan)
                   for _ in range(K)]
        sched.resume()
        results = [h.result(timeout=300) for h in handles]
        stats = sched.stats()
    sched_calls = member.snapshot()["calls"] - before["calls"]
    key = lambda sg: (sg.logical_idx, sg.stage, sg.op_name)
    for r in results:
        _same(r, solo)
        assert {key(s): (s.n_tuples, s.n_llm_calls, s.n_batches)
                for s in r.stage_stats} == {
            key(s): (s.n_tuples, s.n_llm_calls, s.n_batches)
            for s in solo.stage_stats}
    assert stats["n_merged_calls"] >= 1
    assert sched_calls < K * solo_calls
    assert member.snapshot()["fallbacks"] == 0


def test_remote_run_info_snapshot_math():
    a = {"engine": "e", "calls": 2, "retries": 0, "fallbacks": 0,
         "errors": 0, "bytes_sent": 1024, "bytes_recv": 1024,
         "rtt_count": 2, "rtt_total_s": 0.004, "rtt_recent": [0.001, 0.003]}
    assert remote_run_info({"e": a}, {"e": dict(a)}) is None
    b = dict(a, calls=5, rtt_count=5, bytes_recv=3072,
             rtt_recent=[0.001, 0.003, 0.002, 0.002, 0.010])
    info = remote_run_info({"e": a}, {"e": b})
    assert info["calls"] == 3 and info["engines"]["e"]["calls"] == 3
    assert info["wire_kb"] == pytest.approx(2.0)
    assert info["rtt_ms_p50"] == pytest.approx(2.0)
    assert info["rtt_ms_p95"] == pytest.approx(10.0)
    # the reference computes the same footer from the same snapshots
    assert jremote.remote_run_info({"e": a}, {"e": b}) == info


# ---------------------------------------------------------------------------
# robustness: a real worker subprocess, SIGKILLed mid-run
# ---------------------------------------------------------------------------

def test_worker_crash_fallback_and_fail_policies(tmp_path_factory):
    ds = jsyn.make_dataset("remote", N_ITEMS, seed=7)
    proc, addr = spawn_worker(name="fast", device="cpu", **FAST_SPEC)
    fb_sess = _session(
        tmp_path_factory,
        EngineSpec("fast", address=addr, remote_retries=1,
                   on_unavailable="fallback"), "fb")
    fail_sess = _session(
        tmp_path_factory,
        EngineSpec("fast", address=addr, remote_retries=0,
                   on_unavailable="fail"), "ff")
    try:
        assert proc.device == "cpu"
        plan = hand_plan()
        # sync (and fetch + memoize the catalog) while the worker lives;
        # the second session's sync is an idempotent hash check
        fb_sess.prepare(ds.items)
        fail_sess.prepare(ds.items)
        for sess in (fb_sess, fail_sess):
            sess.backend.candidates(QUERY.nodes[0])
            sess.backend.candidates(QUERY.nodes[1])

        # fallback: SIGKILL between partitions of a streaming run;
        # coalesce=1 keeps flushes per partition
        member = remote_members(fb_sess.backend)[0]
        gen = fb_sess.iter_run(plan, QUERY, ds.items, partition_size=30,
                               coalesce=1, dispatcher="inline")
        next(gen)                            # partition 1 over the wire
        assert member.snapshot()["calls"] > 0
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        result = None
        try:
            while True:
                next(gen)
        except StopIteration as stop:
            result = stop.value
        assert result is not None
        assert result.accepted.shape == (len(ds.items),)
        assert result.accepted.dtype == bool
        snap = member.snapshot()
        assert snap["fallbacks"] > 0         # flushes re-routed to gold
        assert snap["retries"] > 0           # transport retries happened

        # fail: same dead worker, the policy raises, the session survives
        with pytest.raises(RemoteEngineError) as ei:
            fail_sess.run(plan, QUERY, ds.items, dispatcher="inline")
        assert ei.value.transport and ei.value.engine == "fast"
        gold = fail_sess.gold(QUERY, ds.items)
        assert gold.accepted.shape == (len(ds.items),)
        gp = gold_plan_for(QUERY, fail_sess.backend)
        again = fail_sess.run(gp, QUERY, ds.items, dispatcher="inline")
        np.testing.assert_array_equal(again.accepted, gold.accepted)
        assert again.remote is None          # gold plan: no wire calls
    finally:
        proc.kill()
        fb_sess.close()
        fail_sess.close()


def test_application_errors_are_never_masked_by_fallback(world):
    ds, _, addr = world
    member = RemoteEngineMember("fast", addr, on_unavailable="fallback")
    try:
        member.sync(ds.items)
        with pytest.raises(RemoteEngineError) as ei:
            member._wire_filter(SemFilter("f1", 1), "no-such-op",
                                ds.items[:4])
        assert not ei.value.transport
        assert "no-such-op" in str(ei.value)
        assert member.snapshot()["fallbacks"] == 0
    finally:
        member.close()


def test_circuit_breaker_opens_and_fails_fast():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    dead = f"127.0.0.1:{probe.getsockname()[1]}"
    probe.close()
    member = RemoteEngineMember("gone", dead, retries=0, backoff_s=0.0,
                                breaker_threshold=2, breaker_reset_s=60.0,
                                on_unavailable="fail")
    for _ in range(2):
        with pytest.raises(RemoteEngineError, match="unreachable"):
            member.health()
    with pytest.raises(RemoteEngineError, match="circuit open"):
        member.health()
    assert member.snapshot()["errors"] == 2


# ---------------------------------------------------------------------------
# wire compatibility: port <-> reference peers over 127.0.0.1
# ---------------------------------------------------------------------------

SM_ONLY = dict(models=("sm",), sm_ratios=(0.5,), lg_ratios=())


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """A reference (JAX) worker and a port worker with one spec (planted
    sm, kv50 and the gold), each served on 127.0.0.1, over 24 items."""
    items = jsyn.make_dataset("wire", 24, seed=11).items
    jw = jremote.RemoteWorker("jax", cache_dir=str(
        tmp_path_factory.mktemp("jw")), **SM_ONLY)
    pw = RemoteWorker("port", cache_dir=str(tmp_path_factory.mktemp("pw")),
                      device="cpu", **SM_ONLY)
    servers = [jremote.start_server(jw), start_server(pw)]
    yield items, jw, pw, servers[0][2], servers[1][2]
    for server, _, _ in servers:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("direction", ["port_member_jax_worker",
                                       "jax_member_port_worker"])
def test_port_and_reference_peers_interoperate(cross, direction):
    items, jw, pw, jaddr, paddr = cross
    if direction == "port_member_jax_worker":
        member = RemoteEngineMember("jax", jaddr)
        served, other = jw, pw          # scores come from the JAX engine
        mine, theirs = tlogical, jlogical
    else:
        member = jremote.RemoteEngineMember("port", paddr)
        served, other = pw, jw
        mine, theirs = jlogical, tlogical
    # the member and `other` share one package's operators, `served` the
    # other package's
    f, m = mine.SemFilter("f1", 1), mine.SemMap("extract v2", 2)
    sf = theirs.SemFilter("f1", 1)
    try:
        h = member.sync(items)
        assert h == proto.corpus_hash(
            (it.item_id, it.tokens) for it in items)
        assert member.health()["corpus_hash"] == h
        assert served._corpus_hash == h
        for op in (f, m):
            assert [(c.name, c.is_gold, c.uses_llm)
                    for c in member.candidates(op)] == [
                (c.name, c.is_gold, c.uses_llm)
                for c in other.backend.candidates(op)]
        # the other package's own scores: its worker synced in-process
        assert other.handle({"verb": "sync", "hash": h,
                             "items": proto.items_to_wire(items)})["ok"]
        for name in ("sm-kv50", "sm-kv00"):
            got = member.score_filter(f, name, items)
            assert got.dtype == np.float32
            # over the wire = the serving engine's own scores, bit for bit
            np.testing.assert_array_equal(
                got, served.backend.score_filter(sf, name, items))
            ref = np.asarray(other.backend.score_filter(f, name, items),
                             np.float32)
            np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
            far = np.abs(ref) > MARGIN
            np.testing.assert_array_equal((got > 0)[far], (ref > 0)[far])
        vals, conf = member.run_map(m, "sm-kv50", items)
        rv, rc = other.backend.run_map(m, "sm-kv50", items)
        np.testing.assert_allclose(conf, rc, atol=ATOL, rtol=0)
        far = np.asarray(rc) > MARGIN
        np.testing.assert_array_equal(np.asarray(vals)[far],
                                      np.asarray(rv)[far])
        assert member.snapshot()["calls"] > 0
        assert member.snapshot()["fallbacks"] == 0
    finally:
        member.close()
