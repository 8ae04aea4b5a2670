"""Concurrent multi-client stress for the port's ShardPS wire
(``paddle_tpu_torch/hostps/wire.py``, a copy of the JAX package's): the
eight tests of ``tests/test_wire_concurrency.py`` on the port, and the two
packages talking to each other over the one file protocol.

The FleetRouter trusts the wire as its data plane: one WireClient shared
by every client thread, a WireServer per replica running a ``workers > 1``
dispatch pool.  These tests pin the wire properties that trust rests on,
in-process (a WireServer is a polling thread over the same filesystem
protocol the multi-process drills use):

- interleaved per-client seq streams from 3+ concurrent clients apply
  in order, exactly once each;
- one WireClient shared across threads matches every reply to its own
  request (per-request reply boxes, process-unique req ids);
- a generation bump lands on EVERY concurrent thread (two-phase commit:
  all raise ShardRestartedError until commit_generation adopts it);
- duplicate retransmits under concurrent load are applied once
  (idempotent seq dedup);
- the workers>1 pool suppresses a retransmit of a request still being
  handled (``hostps.wire.inflight_dup``) instead of handling it twice,
  and actually overlaps blocking handlers (the serving-replica shape);
- expired inbox requests fail fast, typed.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ft import chaos
from paddle_tpu_torch.hostps import wire as ps_wire
from paddle_tpu_torch.monitor.registry import default_registry


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    chaos.disarm()
    yield
    chaos.disarm()


def _counter(name, **labels):
    want = sorted(labels.items())
    total = 0
    for row in default_registry().snapshot():
        if row["name"] != name or row["kind"] != "counter":
            continue
        rl = sorted(row["labels"].items())
        if all(kv in rl for kv in want):
            total += row["value"]
    return total


def _join_all(threads, timeout=60):
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive(), "worker thread wedged: %s" % t.name


def test_three_clients_interleaved_seqs_apply_in_order(tmp_path):
    """3 clients stream seq'd pushes concurrently; the server applies
    each client's stream in order, exactly once, fully (last_seq == N
    per client) — the property the router's control plane (seq-numbered
    swap/retire) and ShardPS push path both lean on."""
    wire = str(tmp_path)
    applied = []        # (client, v) in application order
    alock = threading.Lock()

    def handler(op, payload, client):
        with alock:
            applied.append((client, payload["v"]))
        return {"n": payload["v"]}

    srv = ps_wire.WireServer(wire, 0, handler)
    srv.start()
    n_per = 20
    errors = []

    def run(cid):
        cl = ps_wire.WireClient(wire, cid)
        try:
            for v in range(1, n_per + 1):
                out = cl.request(0, "push", {"v": v}, seq=v)
                assert out == {"n": v}
        except Exception as e:        # surfaced after join
            errors.append((cid, repr(e)))

    try:
        threads = [threading.Thread(target=run, args=("c%d" % i,),
                                    name="wire-c%d" % i)
                   for i in range(3)]
        for t in threads:
            t.start()
        _join_all(threads)
    finally:
        srv.stop()
    assert not errors, errors
    for cid in ("c0", "c1", "c2"):
        mine = [v for c, v in applied if c == cid]
        assert mine == list(range(1, n_per + 1)), (cid, mine)
        assert srv.last_seq(cid) == n_per
    # the streams really interleaved (not a serialized accident): the
    # application order is not 20xC0 then 20xC1 then 20xC2
    order = [c for c, _v in applied]
    assert order != sorted(order), "clients never interleaved"


def test_shared_client_matches_replies_across_threads(tmp_path):
    """One WireClient, many threads (the router's shape: every serving
    client thread submits through the same client): each thread gets ITS
    answer, never a sibling's (per-request reply boxes)."""
    wire = str(tmp_path)
    srv = ps_wire.WireServer(
        wire, 0, lambda op, p, c: {"echo": p["x"] * 2}, workers=4)
    srv.start()
    cl = ps_wire.WireClient(wire, "router")
    errors = []

    def run(tid):
        try:
            for i in range(8):
                x = tid * 1000 + i
                out = cl.request(0, "echo", {"x": x}, deadline=10.0)
                assert out == {"echo": x * 2}, (tid, i, out)
        except Exception as e:
            errors.append((tid, repr(e)))

    try:
        threads = [threading.Thread(target=run, args=(t,),
                                    name="wire-t%d" % t) for t in range(6)]
        for t in threads:
            t.start()
        _join_all(threads)
    finally:
        srv.stop()
    assert not errors, errors


def test_generation_bump_hits_every_concurrent_thread(tmp_path):
    """A respawned server (new generation) must be detected by EVERY
    thread sharing the client — all raise ShardRestartedError until the
    router-side resync calls commit_generation (two-phase adoption), at
    which point requests flow again."""
    wire = str(tmp_path)
    srv = ps_wire.WireServer(wire, 0, lambda op, p, c: {"ok": 1})
    srv.start()
    cl = ps_wire.WireClient(wire, "router")
    assert cl.request(0, "echo", {})["ok"] == 1     # commits first gen
    srv.stop()

    srv2 = ps_wire.WireServer(wire, 0, lambda op, p, c: {"ok": 2})
    assert srv2.generation != srv.generation
    srv2.start()
    verdicts = {}

    def run(tid):
        try:
            cl.request(0, "echo", {}, deadline=5.0)
            verdicts[tid] = "accepted"
        except ps_wire.ShardRestartedError:
            verdicts[tid] = "restart"
        except Exception as e:
            verdicts[tid] = repr(e)

    try:
        threads = [threading.Thread(target=run, args=(t,),
                                    name="wire-gen%d" % t)
                   for t in range(4)]
        for t in threads:
            t.start()
        _join_all(threads)
        assert set(verdicts.values()) == {"restart"}, verdicts
        assert cl.generation_stale(0)
        cl.commit_generation(0)
        assert not cl.generation_stale(0)
        assert cl.request(0, "echo", {})["ok"] == 2
    finally:
        srv2.stop()


def test_duplicate_retransmits_under_load_apply_once(tmp_path):
    """Chaos-dup'd sends while 3 clients stream concurrently: every
    (client, seq) applies exactly once — the dedup holds under
    interleaving, not just in the single-client unit test."""
    wire = str(tmp_path)
    applied = []
    alock = threading.Lock()

    def handler(op, payload, client):
        with alock:
            applied.append((client, payload["v"]))
        return {"n": payload["v"]}

    srv = ps_wire.WireServer(wire, 0, handler)
    srv.start()
    dup0 = _counter("hostps.wire.dup_sent")
    chaos.arm("ps_dup", at=2, times=6)
    errors = []

    def run(cid):
        cl = ps_wire.WireClient(wire, cid)
        try:
            for v in range(1, 9):
                cl.request(0, "push", {"v": v}, seq=v)
        except Exception as e:
            errors.append((cid, repr(e)))

    try:
        threads = [threading.Thread(target=run, args=("d%d" % i,),
                                    name="wire-dup%d" % i)
                   for i in range(3)]
        for t in threads:
            t.start()
        _join_all(threads)
        # drain: the -dup.msg ghosts are met AFTER the originals replied
        time.sleep(0.3)
    finally:
        srv.stop()
    assert not errors, errors
    assert _counter("hostps.wire.dup_sent") - dup0 >= 1
    seen = {}
    for key in applied:
        seen[key] = seen.get(key, 0) + 1
    doubles = {k: n for k, n in seen.items() if n != 1}
    assert not doubles, "applied more than once: %r" % doubles
    assert len(seen) == 3 * 8


def test_pool_suppresses_retransmit_of_inflight_request(tmp_path):
    """workers>1: a deadline-driven retransmit of a request STILL being
    handled is dropped (hostps.wire.inflight_dup) — the original's reply
    answers the client — instead of riding the engine twice."""
    wire = str(tmp_path)
    release = threading.Event()
    calls = []

    def handler(op, payload, client):
        calls.append(op)
        assert release.wait(10.0)
        return {"ok": 1}

    srv = ps_wire.WireServer(wire, 0, handler, workers=2, poll=0.005)
    srv.start()
    cl = ps_wire.WireClient(wire, "c", deadline=0.4, poll=0.005)
    d0 = _counter("hostps.wire.inflight_dup")
    threading.Timer(1.0, release.set).start()
    try:
        # attempt 1 blocks in the handler past its 0.4s deadline; the
        # attempt-2 resend (same req id) lands while it is in flight and
        # must be suppressed, then the released original answers both
        out = cl.request(0, "block", {}, attempts=4)
        assert out == {"ok": 1}
    finally:
        release.set()
        srv.stop()
    assert len(calls) == 1, "handler ran %d times" % len(calls)
    assert _counter("hostps.wire.inflight_dup") - d0 >= 1


def test_pooled_server_applies_back_to_back_seqs_in_order(tmp_path):
    """Seq'd (control-plane) ops on a workers>1 server dispatch INLINE on
    the drain thread: two back-to-back seqs already sitting in the inbox
    apply in order even though the first blocks.  The pooled path used to
    hand seq 1 to a worker and immediately read a stale dedup floor for
    seq 2 — a spurious 'seq gap' refusal on an in-order client stream."""
    wire = str(tmp_path)
    applied = []

    def handler(op, payload, client):
        time.sleep(0.15)      # the blocking-control shape (swap boundary)
        applied.append(payload["v"])
        return {"n": payload["v"]}

    cl = ps_wire.WireClient(wire, "ctl", poll=0.005)
    # stage BOTH requests before the server drains anything — the exact
    # interleaving the dedup-read-before-handle race needs
    reqs = []
    for v in (1, 2):
        rid = cl._next_req_id()
        cl._send(0, rid, {"op": "push", "payload": {"v": v},
                          "client": "ctl", "seq": v, "req": rid})
        reqs.append(rid)
    srv = ps_wire.WireServer(wire, 0, handler, workers=4, poll=0.005)
    srv.start()
    try:
        replies = [cl._await_reply(r, 10.0) for r in reqs]
    finally:
        srv.stop()
    for v, reply in zip((1, 2), replies):
        assert reply["ok"], (v, reply)
        assert reply["result"] == {"n": v}
    assert applied == [1, 2]
    assert srv.last_seq("ctl") == 2


def test_pool_overlaps_blocking_handlers(tmp_path):
    """workers=4 really dispatches in parallel: four 0.25s-blocking
    requests complete in well under the 1.0s a serialized inbox would
    take (the serving-replica shape — N requests riding one engine
    step)."""
    wire = str(tmp_path)
    srv = ps_wire.WireServer(
        wire, 0, lambda op, p, c: (time.sleep(0.25), {"ok": 1})[1],
        workers=4, poll=0.005)
    srv.start()
    cl = ps_wire.WireClient(wire, "c", poll=0.005)
    errors = []

    def run(tid):
        try:
            assert cl.request(0, "x", {}, deadline=10.0)["ok"] == 1
        except Exception as e:
            errors.append((tid, repr(e)))

    try:
        threads = [threading.Thread(target=run, args=(t,),
                                    name="wire-par%d" % t)
                   for t in range(4)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        _join_all(threads)
        wall = time.perf_counter() - t0
    finally:
        srv.stop()
    assert not errors, errors
    assert wall < 0.85, "pool serialized: 4x0.25s took %.2fs" % wall


def test_pool_fast_fails_expired_inbox_request_typed(tmp_path):
    """Deadline propagation's server half under a workers>1 pool: an
    unseq'd request whose ``expires`` passed while it sat in the inbox is
    answered with a typed ``code="deadline"`` reply WITHOUT the handler
    ever running, and a retransmit — the record is built once, so it
    carries the same expiry — can never execute either.  A live request
    on the same pool still serves: the fast-fail frees the slot, it does
    not poison the server."""
    wire = str(tmp_path)
    calls = []

    def handler(op, payload, client):
        calls.append(op)
        return {"served": 1}

    cl = ps_wire.WireClient(wire, "dl", poll=0.005)
    exp0 = _counter("hostps.wire.expired")
    # stage the request BEFORE the server starts, expiry already past —
    # the queued-then-abandoned shape deadline propagation exists for
    rid = cl._next_req_id()
    rec = {"op": "score", "payload": {}, "client": "dl", "seq": None,
           "req": rid, "expires": time.time() - 0.05}
    cl._send(0, rid, rec)
    srv = ps_wire.WireServer(wire, 0, handler, workers=2, poll=0.005)
    srv.start()
    try:
        reply = cl._await_reply(rid, 10.0)
        assert reply["ok"] is False
        assert reply.get("code") == "deadline"
        assert "expired" in reply["error"]
        # the retransmit (same record, same expires) after the first
        # typed refusal: fast-failed again, handler still never runs
        cl._send(0, rid, rec)
        reply2 = cl._await_reply(rid, 10.0)
        assert reply2.get("code") == "deadline"
        # the pool is healthy: a fresh, unexpired request serves
        assert cl.request(0, "fresh", {}, deadline=5.0) == {"served": 1}
    finally:
        srv.stop()
    assert calls == ["fresh"], "expired request executed: %r" % calls
    assert _counter("hostps.wire.expired") - exp0 >= 2


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_the_two_packages_share_the_wire(tmp_path, server_pkg):
    """A port client against the JAX package's server and the other way
    round: seq'd pushes apply once and in order, numpy arrays cross
    untouched, a remote error comes back typed."""
    from paddle_tpu.hostps import wire as jwire

    srv_mod, cl_mod = ((jwire, ps_wire) if server_pkg == "jax"
                       else (ps_wire, jwire))
    applied = []

    def handler(op, payload, client):
        if op == "boom":
            raise RuntimeError("no")
        applied.append(int(payload["seq"]))
        return {"rows": payload["rows"] * 2, "n": len(applied)}

    srv = srv_mod.WireServer(str(tmp_path), 0, handler)
    srv.start()
    try:
        cl = cl_mod.WireClient(str(tmp_path), "x")
        rows = np.arange(6, dtype=np.int64)
        for seq in (1, 2, 3):
            out = cl.request(0, "push", {"seq": seq, "rows": rows}, seq=seq)
            np.testing.assert_array_equal(out["rows"], rows * 2)
            assert out["n"] == seq
        assert applied == [1, 2, 3]
        with pytest.raises(Exception, match="boom"):
            cl.request(0, "boom", {})
    finally:
        srv.stop()
