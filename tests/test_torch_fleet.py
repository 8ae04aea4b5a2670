"""The port's serving fleet (``paddle_tpu_torch/serving/router.py`` and
``fleet.py``) against the JAX package's on the CPU.

The reference's router, fleet and router-side shield cases
(``tests/test_serving.py``, ``test_replica_info_fit_waste`` to
``test_router_load_sum_tracks_every_mutation``) run against the port, and
the routing decisions of both packages' routers are held equal on one
seeded sequence of picks and replies.  Then a real port fleet, started
once for the module: a ShardPS owner serving a read-only table in this
process, two replica processes (``--device cpu``) over one model saved by
the JAX package and exported by the port, and a ``FleetRouter`` here.
Every request's output is held to the JAX package's
``create_predictor(...).run`` on the same feed, with the rows from a JAX
twin of the table, within rtol 1e-5 / atol 1e-6 (the two frameworks sum
the matmuls in other orders).  A replica is SIGKILLed mid-trace with zero
drops, respawned on its inbox and adopted; a rolling swap and a retire
end the run.
"""

import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.serving  # noqa: F401
import paddle_tpu_torch as pfluid
from paddle_tpu_torch import monitor as pmon
from paddle_tpu_torch.hostps import HostSparseTable, ShardServer
from paddle_tpu_torch.hostps import wire as ps_wire
from paddle_tpu_torch.monitor.registry import StatRegistry
from paddle_tpu_torch.serving import (FleetCTRView, FleetManager,
                                      FleetRouter, ReplicaInfo,
                                      autoscale_signal)
from paddle_tpu_torch.tools import serve_bench as sb

RTOL, ATOL = 1e-5, 1e-6
VOCAB, DIM, FIELDS = 64, 4, 4
FEEDS = ["x:12:float32", "emb:16:float32"]


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------- the reference's router cases --

def test_replica_info_fit_waste():
    info = ReplicaInfo(0)
    info.batch_buckets, info.max_batch = (2, 4, 8), 8
    assert [info.fit_waste(r) for r in (1, 2, 3, 4, 5, 8)] \
        == [1, 0, 1, 0, 3, 0]
    # >= max_batch spans steps — waste 0, any replica fits it equally
    assert info.fit_waste(9) == 0
    # identity not yet known (hello pending): every fit is neutral
    assert ReplicaInfo(1).fit_waste(5) == 0


def _router_with(tmp_path, idents, router_cls=FleetRouter, registry=None):
    """A router over ``{rid: (buckets, load)}`` with no wire I/O — the hot
    path under test is pure bookkeeping by design."""
    router = router_cls(str(tmp_path), replicas=sorted(idents),
                        registry=registry or StatRegistry())
    for rid, (buckets, load) in idents.items():
        info = router._replicas[rid]
        info.batch_buckets = tuple(buckets)
        info.max_batch = max(buckets)
        info.depth = int(load)
    router._rebuild_order()
    return router


def test_router_pick_prefers_fit_then_load_then_round_robin(tmp_path):
    # fit first: rows=2 wastes 0 on r1's lattice, 6 on r0's — load loses
    router = _router_with(tmp_path, {0: ((8,), 0), 1: ((2, 4, 8), 5)})
    picked = router._pick(2)
    assert picked.rid == 1
    router._note_reply(picked, {"depth": 5})
    # equal fit: least load wins
    router = _router_with(tmp_path, {0: ((2, 4), 3), 1: ((2, 4), 1)})
    assert router._pick(2).rid == 1
    # equal fit and load: the round-robin cursor rotates the tie
    router = _router_with(tmp_path, {0: ((4,), 0), 1: ((4,), 0)})
    seen = set()
    for _ in range(4):
        picked = router._pick(4)
        seen.add(picked.rid)
        router._note_reply(picked, {"depth": 0})    # release the charge
    assert seen == {0, 1}


def test_router_pick_skips_suspects_until_cooloff(tmp_path):
    router = _router_with(tmp_path, {0: ((4,), 0), 1: ((4,), 9)})
    router._replicas[0].suspect_until = time.monotonic() + 60
    assert router._pick(4).rid == 1       # the idle replica is suspect
    # everyone suspect or excluded -> None (the submit loop breathes)
    router._replicas[1].suspect_until = time.monotonic() + 60
    assert router._pick(4) is None
    router._replicas[0].suspect_until = 0.0
    assert router._pick(4).rid == 0       # cool-off expiry readmits
    assert router._pick(4, exclude={0, 1}) is None


def test_router_note_reply_folds_piggybacked_load(tmp_path):
    router = _router_with(tmp_path, {0: ((4,), 0)})
    info = router._pick(4)
    assert info.outstanding == 1          # _pick charges the dispatch
    router._note_reply(info, {"depth": 7, "inflight": 3, "version": 9})
    assert (info.outstanding, info.depth, info.inflight, info.version,
            info.served) == (0, 7, 3, 9, 1)
    # a failed attempt only releases the charge — no stale fold-in
    info2 = router._pick(4)
    router._note_reply(info2, None, ok=False)
    assert info.outstanding == 0 and info.served == 1


def test_autoscale_signal_both_directions():
    reg = StatRegistry()

    def snap(loads, suspect=()):
        return {i: {"depth": d, "outstanding": 0, "suspect": i in suspect}
                for i, d in enumerate(loads)}

    d, why, ml = autoscale_signal(snap([6, 6, 6]), high_load=4.0,
                                  registry=reg)
    assert (d, why, ml) == (4, "queue_depth", 6.0)
    d, why, _ = autoscale_signal(snap([0, 0, 0]), low_load=0.25,
                                 min_replicas=1, registry=reg)
    assert (d, why) == (2, "idle")
    # bounds clamp both directions
    d, _, _ = autoscale_signal(snap([9, 9]), high_load=1.0,
                               max_replicas=2, registry=reg)
    assert d == 2
    d, why, _ = autoscale_signal(snap([0]), min_replicas=1, registry=reg)
    assert (d, why) == (1, "steady")
    # memory headroom gone -> scale up even when queues look fine
    d, why, _ = autoscale_signal(snap([1, 1]), hbm_frac=0.95,
                                 high_load=4.0, registry=reg)
    assert (d, why) == (3, "memory_headroom")
    # a suspect replica is excluded from mean load, desired holds n
    d, why, _ = autoscale_signal(snap([0, 8], suspect={0}), high_load=9.0,
                                 low_load=0.0, registry=reg)
    assert d == 2
    # a partial outage must NEVER read as "idle"
    d, why, _ = autoscale_signal(snap([0, 0, 0], suspect={0, 1}),
                                 low_load=0.25, min_replicas=1,
                                 registry=reg)
    assert (d, why) == (3, "replacing_suspects")
    # a firing incident is cited in the reason
    d, why, _ = autoscale_signal(
        snap([0, 0], suspect={1}), registry=reg,
        alerts=lambda: [{"rule": "replica_dead", "incident": "inc-0007"}])
    assert (d, why) == (2, "replacing_suspects:inc-0007")
    assert reg.gauge("fleet.autoscale.desired").value == 2


def test_router_respawn_adoption_resets_control_seq(tmp_path):
    """A respawned replica starts an empty seq-dedup table expecting seq
    1 — adoption (the ShardRestartedError path) must reseed the router's
    control counter from the fresh server's hello."""
    wire = str(tmp_path)

    def make_handler(box, tag):
        def handler(op, payload, client):
            if op == "hello":
                return {"batch_buckets": [4], "max_batch": 4,
                        "pid": os.getpid(), "version": tag,
                        "last_seq": box[0].last_seq(client)}
            if op == "submit":
                return {"outputs": [tag], "depth": 0, "inflight": 0,
                        "version": tag}
            if op == "swap":
                return {"replica": 0, "version": payload["version"]}
            raise ValueError(op)
        return handler

    box = [None]
    box[0] = srv = ps_wire.WireServer(wire, 0, make_handler(box, "g1"),
                                      workers=4, poll=0.005)
    srv.start()
    srv.mark_ready()
    router = FleetRouter(wire, replicas=[0], registry=StatRegistry(),
                         deadline=5.0, poll=0.005).connect(timeout=10.0)
    info = router._replicas[0]
    router._control(info, "swap", {"version": "v2"})
    assert (info.next_seq, srv.last_seq(router.wire.client_id)) == (2, 1)
    srv.stop()

    box2 = [None]
    box2[0] = srv2 = ps_wire.WireServer(wire, 0, make_handler(box2, "g2"),
                                        workers=4, poll=0.005)
    srv2.start()
    srv2.mark_ready()
    try:
        out = router.submit({"x": np.zeros((2, 3), np.float32)},
                            timeout=20.0)
        assert out == ["g2"]
        assert info.next_seq == 1, "seq floor not reseeded on adoption"
        res = router._control(info, "swap", {"version": "v3"})
        assert res["version"] == "v3"
        assert srv2.last_seq(router.wire.client_id) == 1
        assert router.registry.counter("fleet.replica_restarts").value == 1
    finally:
        srv2.stop()


def test_apply_autoscale_spawns_past_adopted_replicas(tmp_path):
    mgr = FleetManager(str(tmp_path), "artifact", str(tmp_path),
                       feeds=["x:4:float32"], device="cpu")

    class AdoptedRouter:
        added = None

        def replica_ids(self):
            return [0, 1, 2]

        def add_replica(self, rid):
            self.added = rid

    spawned = []
    mgr.spawn = lambda rid: spawned.append(rid)
    mgr.wait_ready = lambda rids: None
    router = AdoptedRouter()
    action, rid = mgr.apply_autoscale(router, desired=4)
    assert (action, rid) == ("spawn", 3)
    assert spawned == [3] and router.added == 3


def test_fleet_parse_feed_triples():
    from paddle_tpu_torch.serving.fleet import _parse_feed

    assert _parse_feed(["x:12:float32", "tok:seq:int32",
                        "img:4,4:float32"]) \
        == {"x": ((12,), "float32"), "tok": (("seq",), "int32"),
            "img": ((4, 4), "float32")}


def test_shield_config_inert_defaults_on_the_router(tmp_path):
    router = _router_with(tmp_path, {0: ((4,), 0), 1: ((4,), 0)})
    assert not router._shed_armed
    assert all(info.breaker is None for info in router._replicas.values())


def test_router_submit_sheds_typed_when_armed(tmp_path):
    from paddle_tpu_torch.serving.queue import Shed

    router = FleetRouter(str(tmp_path), replicas=[0],
                         registry=StatRegistry(),
                         shield={"watermark": 2.0, "retry_after_ms": 40.0})
    assert router._shed_armed
    info = router._replicas[0]
    info.batch_buckets, info.max_batch = (4,), 4
    info.depth = 5
    router._rebuild_order()
    with pytest.raises(Shed) as exc:
        router.submit({"x": np.zeros((2, 4), np.float32)}, priority=0)
    assert exc.value.retry_after_ms == 40.0
    assert router.shield_snapshot()["sheds"] == 1
    assert router.shed.verdict(2, router._mean_load()) is None


def test_router_load_sum_tracks_every_mutation(tmp_path):
    router = _router_with(tmp_path, {0: ((4,), 0), 1: ((4,), 0)})

    def recount():
        return sum(i.outstanding + i.depth
                   for i in router._replicas.values())

    a = router._pick(4)
    b = router._pick(4)
    assert router._load_sum == recount() == 2
    router._note_reply(a, {"depth": 7})
    assert router._load_sum == recount() == 8
    router._note_reply(b, None, ok=False)
    assert router._load_sum == recount() == 7
    c = router._pick(4)
    router._unpick(c)
    assert router._load_sum == recount() == 7
    assert router._mean_load() == 3.5


def test_router_decisions_match_the_jax_package(tmp_path):
    """One seeded sequence of picks, replies, failures, suspicions and
    cool-off lapses through both packages' routers: the same replica
    picked every time, the same books after."""
    idents = {0: ((2, 4, 8), 0), 1: ((4, 8), 2), 2: ((8,), 1)}
    routers = [_router_with(tmp_path / "p", idents),
               _router_with(tmp_path / "j", idents,
                            router_cls=jfluid.serving.FleetRouter)]
    rng = np.random.RandomState(5)
    picks = [[], []]
    for step in range(200):
        rows = int(rng.randint(1, 10))
        verdict = rng.randint(0, 6)
        depth = int(rng.randint(0, 5))
        exclude = {int(rng.randint(0, 3))} if rng.rand() < 0.2 else set()
        for k, router in enumerate(routers):
            info = router._pick(rows, exclude)
            picks[k].append(None if info is None else info.rid)
            if info is None:
                for i in router._replicas.values():
                    i.suspect_until = 0.0       # lapse every cool-off
                continue
            if verdict == 0:
                router._note_reply(info, None, ok=False)
            elif verdict == 1:
                router._suspect(info, "WireTimeout", ms=5.0)
                info.suspect_until = 1e18 if step % 3 else 0.0
            else:
                router._note_reply(info, {"depth": depth, "inflight": 1,
                                          "version": step})
    assert picks[0] == picks[1]
    assert len({p for p in picks[0] if p is not None}) == 3
    books = [{rid: {k: v for k, v in s.items() if k != "suspect"}
              for rid, s in r.snapshot().items()} for r in routers]
    assert books[0] == books[1]
    assert routers[0]._load_sum == routers[1]._load_sum


def test_fleet_ctr_view_pulls_read_only_from_the_owner(tmp_path):
    """The view's rows equal the owner table's read-only pull bit for
    bit, out-of-vocab ids read zeros, and the owner writes nothing."""
    table = HostSparseTable(VOCAB, DIM, seed=11, name="serve_ctr")
    twin = HostSparseTable(VOCAB, DIM, seed=11, name="serve_ctr")
    srv = ShardServer(table, str(tmp_path), 0, poll=0.005).start()
    try:
        view = FleetCTRView(str(tmp_path), 1, VOCAB, DIM, deadline=5.0,
                            registry=StatRegistry()).connect(timeout=10)
        ids = np.array([[3, 70, 5], [-1, 3, 63]], np.int64)
        got = view.pull(ids)
        assert got.shape == (2, 3, DIM) and got.dtype == np.float32
        assert got.tobytes() == twin.pull(ids, materialize=False).tobytes()
        assert not got[0, 1].any() and not got[1, 0].any()
        assert table.rows_initialized == 0 and not view.degraded_recent()
    finally:
        srv.stop()


# ------------------------------------------------- a real fleet on the CPU --

def _lookup_rows(table, ids):
    return np.asarray(table.pull(ids, materialize=False),
                      np.float32).reshape(ids.shape[0], -1)


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory):
    """Start the fleet, drive it through a trace, a mid-trace kill, a
    respawn, a rolling swap and a retire; returns what each leg saw."""
    work = tmp_path_factory.mktemp("fleet")
    saved = str(work / "model")
    sb.build_artifact(jfluid, saved, np.random.RandomState(0),
                      exported=False)
    sb.export(pfluid, saved, {"x": (4, 12), "emb": (4, 16)}, "cpu")
    ps_dir, fleet_dir = str(work / "ps-wire"), str(work / "fleet-wire")
    mon_root = str(work / "monitor")
    table = HostSparseTable(VOCAB, DIM, seed=11, name="serve_ctr")
    owner = ShardServer(table, ps_dir, 0, poll=0.005).start()
    mgr = FleetManager(fleet_dir, saved, mon_root, FEEDS, buckets="2,4,8",
                       workers=4, device="cpu",
                       env=dict(os.environ, OMP_NUM_THREADS="1"),
                       ctr={"wire_dir": ps_dir, "world": 1, "vocab": VOCAB,
                            "dim": DIM})
    mon = pmon.enable(os.path.join(mon_root, "router"))
    res = {"table": table, "saved": saved, "served": [], "errors": [],
           "mon_dir": os.path.join(mon_root, "router")}
    lock = threading.Lock()
    try:
        for rid in (0, 1):
            mgr.spawn(rid)
        mgr.wait_ready([0, 1], timeout=180)
        router = FleetRouter(fleet_dir, replicas=[0, 1], deadline=2.0,
                             poll=0.004, suspect_cooloff=1.0,
                             registry=mon.registry).connect(timeout=60)
        res["hello"] = {rid: (i.batch_buckets, i.max_batch)
                        for rid, i in router._replicas.items()}

        def client(cid, n, stop=None):
            rng = np.random.RandomState(100 + cid)
            for _ in range(n):
                if stop is not None and stop.is_set():
                    return
                rows = int(rng.choice((1, 2, 3, 5, 8)))
                feed = {"x": rng.rand(rows, 12).astype("f4"),
                        "ids": rng.randint(0, VOCAB + 8, (rows, FIELDS))}
                try:
                    out = router.submit(dict(feed))
                except Exception as e:     # FleetGiveUp included: a drop
                    with lock:
                        res["errors"].append(repr(e))
                    return
                with lock:
                    res["served"].append((feed, out[0]))

        # -- leg 1: the trace over two replicas ------------------------------
        threads = [threading.Thread(target=client, args=(c, 8))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        res["leg1"] = len(res["served"])
        res["stats"] = {rid: router.stats(rid) for rid in (0, 1)}

        # -- leg 2: SIGKILL replica 1 with clients in flight -----------------
        stop = threading.Event()
        threads = [threading.Thread(target=client, args=(10 + c, 400, stop))
                   for c in range(4)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        n_kill = len(res["served"])
        mgr.kill(1)
        mgr.procs[1].wait(timeout=30)
        deadline = time.monotonic() + 60
        while (router.snapshot()[1]["rerouted_away"] < 1
               or len(res["served"]) < n_kill + 20):
            if time.monotonic() > deadline or res["errors"]:
                break
            time.sleep(0.1)
        res["after_kill"] = len(res["served"]) - n_kill
        res["snap_kill"] = router.snapshot()

        # -- leg 3: respawn replica 1 on its inbox; the router adopts it -----
        mgr.spawn(1)
        rp = ps_wire.ready_path(fleet_dir, 1)
        pid = str(mgr.procs[1].pid)
        deadline = time.monotonic() + 180
        while time.monotonic() < deadline:
            try:
                with open(rp) as f:
                    if f.read().strip() == pid:
                        break
            except OSError:
                pass
            time.sleep(0.1)
        served1 = router.snapshot()[1]["served"]
        deadline = time.monotonic() + 60
        while (router.snapshot()[1]["served"] <= served1
               and time.monotonic() < deadline and not res["errors"]):
            router._replicas[1].suspect_until = 0.0   # readmit now
            time.sleep(0.2)
        stop.set()
        for t in threads:
            t.join(timeout=300)
        res["snap_respawn"] = router.snapshot()
        res["served1_before"] = served1

        # -- leg 4: rolling swap to a second weight set, then retire ---------
        with np.load(os.path.join(saved, "__params__.npz")) as z:
            state2 = {k: (z[k] * np.float32(0.5)).astype(z[k].dtype)
                      for k in z.files}
        state_path = str(work / "params2.npz")
        np.savez(state_path, **state2)
        res["saved2"] = str(work / "model2")
        shutil.copytree(saved, res["saved2"])
        sb.write_params(res["saved2"], state2)
        res["swap"] = router.rolling_swap(2, state_path, deadline=60.0)
        rng = np.random.RandomState(7)
        res["post_swap"] = []
        for _ in range(6):
            feed = {"x": rng.rand(3, 12).astype("f4"),
                    "ids": rng.randint(0, VOCAB, (3, FIELDS))}
            res["post_swap"].append((feed, router.submit(dict(feed))[0]))
        res["versions"] = {rid: router.stats(rid)["version"]
                           for rid in (0, 1)}
        res["retire"] = {rid: router.retire(rid) for rid in (0, 1)}
        res["rcs"] = {rid: mgr.wait(rid, timeout=60) for rid in (0, 1)}
        mon.timeline.flush()
        res["events"] = [e["ev"] for e in _events(res["mon_dir"])]
        res["counters"] = {k: mon.registry.counter(k).value for k in (
            "fleet.rerouted", "fleet.replica_restarts", "fleet.dispatched")}
    finally:
        pmon.disable()
        mgr.stop_all(timeout=20)
        owner.stop()
    return res


def _events(mon_dir):
    path = os.path.join(mon_dir, "timeline.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _jax_twin():
    from paddle_tpu.hostps import HostSparseTable as JTable

    return JTable(VOCAB, DIM, seed=11, name="serve_ctr")


def test_fleet_replicas_capture_their_lattice(fleet_run):
    assert fleet_run["hello"] == {0: ((2, 4, 8), 8), 1: ((2, 4, 8), 8)}
    for rid, s in fleet_run["stats"].items():
        assert s["precompile_sources"] == {"cached": 0, "disk": 0,
                                           "compiled": 3}, rid
        assert s["recompiles"] == 0 and s["new_compiled_sigs"] == 0


def test_fleet_outputs_match_the_jax_predictor(fleet_run):
    """Every request served by the fleet, before, across and after the
    kill, against the JAX package's predictor on the JAX twin's rows."""
    assert not fleet_run["errors"], fleet_run["errors"][:3]
    twin = _jax_twin()
    cfg = jfluid.inference.AnalysisConfig(fleet_run["saved"])
    pred = jfluid.inference.create_predictor(cfg)
    assert len(fleet_run["served"]) >= 32 + 20
    for feed, got in fleet_run["served"]:
        emb = _lookup_rows(twin, feed["ids"])
        (want,) = pred.run({"x": feed["x"], "emb": emb})
        assert got.shape == (feed["x"].shape[0], 1)
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    assert fleet_run["table"].rows_initialized == 0


def test_fleet_kill_mid_trace_drops_nothing(fleet_run):
    assert not fleet_run["errors"], fleet_run["errors"][:3]
    assert fleet_run["after_kill"] >= 20
    assert fleet_run["snap_kill"][1]["rerouted_away"] >= 1
    assert fleet_run["counters"]["fleet.rerouted"] >= 1
    assert "fleet_reroute" in fleet_run["events"]


def test_fleet_respawn_is_adopted(fleet_run):
    assert fleet_run["counters"]["fleet.replica_restarts"] >= 1
    assert "fleet_replica_restart" in fleet_run["events"]
    assert (fleet_run["snap_respawn"][1]["served"]
            > fleet_run["served1_before"])


def test_fleet_rolling_swap_serves_the_new_weights(fleet_run):
    assert sorted(fleet_run["swap"]) == [0, 1]
    assert fleet_run["versions"] == {0: 2, 1: 2}
    assert fleet_run["events"].count("fleet_swap") == 2
    twin = _jax_twin()
    pred = jfluid.inference.create_predictor(
        jfluid.inference.AnalysisConfig(fleet_run["saved2"]))
    for feed, got in fleet_run["post_swap"]:
        (want,) = pred.run({"x": feed["x"],
                            "emb": _lookup_rows(twin, feed["ids"])})
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_fleet_retire_drains_every_replica(fleet_run):
    assert fleet_run["rcs"] == {0: 0, 1: 0}
    for rid, r in fleet_run["retire"].items():
        assert r["replica"] == rid
        assert r["summary"]["recompiles"] == 0
        assert r["summary"]["completed"] >= 1
