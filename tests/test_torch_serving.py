"""The port's serving tier (``paddle_tpu_torch/serving``: queue, metrics,
shield, engine, canary) against the JAX package's on the CPU.

One model saved by the JAX package's ``save_inference_model``; two copies
of its directory, each exported by its own package; one request trace from
a numpy seed served by both packages' ``ServeEngine``s.  Tolerance: the
reference's serving tolerance, rtol 1e-5 and atol 1e-6 (f32; the two
frameworks sum the matmuls in other orders, and different buckets may
differ in the last ulp).  Counters, the ``(rows, bucket)`` sequence of the
``serve`` events and the read-only lookup's rows are held exactly.  The
rest ports the reference's own cases (``tests/test_serving.py``, the
engine-swap cases of ``tests/test_online.py`` and the canary case of
``tests/test_watchtower.py``) wherever they need no router or fleet; on the
CPU the exported predictor runs its module directly (the CUDA-graph route
is ``test_torch_serving_cuda.py``'s).
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.serving  # noqa: F401
import paddle_tpu_torch as pfluid
from paddle_tpu_torch import monitor as pmon
from paddle_tpu_torch import serving
from paddle_tpu_torch.hostps import HostPSEmbedding, HostSparseTable
from paddle_tpu_torch.inference import (export_inference_model,
                                        load_exported_model)
from paddle_tpu_torch.monitor.recompile import RecompileStorm
from paddle_tpu_torch.monitor.registry import StatRegistry
from paddle_tpu_torch.serving import (Backpressure, BucketLattice, CTRLookup,
                                      RequestTooLarge, ServeEngine, ServeError)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
FEED_SPEC = {"x": ((12,), "float32")}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------- fixtures --

def _save_with_jax(dirname, with_seq=False):
    """The reference's serving model, trained two steps and saved by the
    JAX package."""
    fluid = jfluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if with_seq:
            x = fluid.layers.data("x", shape=[8], dtype="float32")
            pred = fluid.layers.scale(x, scale=2.5)
        else:
            x = fluid.layers.data("x", shape=[12], dtype="float32")
            y = fluid.layers.data("y", shape=[1], dtype="float32")
            h = fluid.layers.fc(x, size=16, act="relu")
            pred = fluid.layers.fc(h, size=1)
            loss = fluid.layers.mean(
                fluid.layers.square_error_cost(pred, y))
            fluid.optimizer.SGD(0.05).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    if not with_seq:
        rng = np.random.RandomState(0)
        for _ in range(2):
            exe.run(main, feed={"x": rng.rand(16, 12).astype("f4"),
                                "y": rng.rand(16, 1).astype("f4")},
                    fetch_list=[loss])
    fluid.io.save_inference_model(dirname, ["x"], [pred], exe,
                                  main_program=main)
    return dirname


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """(port artifact, JAX artifact): one saved model, two exports."""
    saved = _save_with_jax(str(tmp_path_factory.mktemp("saved")))
    pdir = str(tmp_path_factory.mktemp("port_export"))
    jdir = str(tmp_path_factory.mktemp("jax_export"))
    for d in (pdir, jdir):
        shutil.copytree(saved, d, dirs_exist_ok=True)
    export_inference_model(pdir, {"x": (4, 12)}, poly_batch=True,
                           device="cpu")
    jfluid.inference.export_inference_model(jdir, feed_shapes={"x": (4, 12)},
                                            poly_batch=True)
    return pdir, jdir


@pytest.fixture(scope="module")
def artifact(artifacts):
    return artifacts[0]


@pytest.fixture(scope="module")
def seq_artifact(tmp_path_factory):
    d = _save_with_jax(str(tmp_path_factory.mktemp("seq")), with_seq=True)
    export_inference_model(d, {"x": (2, 8)}, poly_axes={"x": {0: "b", 1: "l"}},
                           device="cpu")
    return d


def _ep(dirname):
    return load_exported_model(dirname, device="cpu")


def _trace(seed, sizes=(3, 1, 20, 2, 8, 5, 1, 4, 17, 2)):
    rng = np.random.RandomState(seed)
    return [rng.rand(s, 12).astype("f4") for s in sizes]


# ------------------------------------------------- held to the JAX package --

def _serve_static(pkg, dirname, trace, mon_dir, name):
    """One package's static engine over ``trace`` under its monitor:
    (outputs, summary, [(rows, bucket)] of its serve events)."""
    monitor = pkg.monitor
    monitor.enable(mon_dir)
    try:
        if pkg is pfluid:
            ep = _ep(dirname)
        else:
            ep = pkg.inference.load_exported_model(dirname)
        eng = pkg.serving.ServeEngine(ep, pkg.serving.BucketLattice([4, 8]),
                                      feed_spec=FEED_SPEC, mode="static",
                                      name=name)
        with eng:
            futs = [eng.submit({"x": x}) for x in trace]
            outs = [f.result(timeout=120)[0] for f in futs]
    finally:
        monitor.disable()
    events = monitor.read_events(os.path.join(mon_dir, "timeline.jsonl"))
    steps = [(e["rows"], e["bucket"]) for e in events
             if e.get("ev") == "serve"]
    return outs, eng.last_summary, steps


def test_static_engines_agree_with_the_jax_package(artifacts, tmp_path):
    pdir, jdir = artifacts
    trace = _trace(11)
    pout, psum, psteps = _serve_static(pfluid, pdir, trace,
                                       str(tmp_path / "p"), "agree_p")
    jout, jsum, jsteps = _serve_static(jfluid, jdir, trace,
                                       str(tmp_path / "j"), "agree_j")
    for x, got, want in zip(trace, pout, jout):
        assert got.shape == want.shape == (x.shape[0], 1)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for key in ("completed", "admitted", "evicted", "rows", "points",
                "recompiles", "new_compiled_sigs", "backpressure", "steps"):
        assert psum[key] == jsum[key], key
    assert psum["completed"] == len(trace) and psum["new_compiled_sigs"] == 0
    assert psteps == jsteps and len(psteps) == psum["steps"]


def test_ctr_lookup_rows_bit_for_bit_with_the_jax_package():
    from paddle_tpu.hostps.service import HostPSEmbedding as JEmb
    from paddle_tpu.hostps.table import HostSparseTable as JTable

    rng = np.random.RandomState(6)
    ids = rng.randint(0, 128, size=(5, 3)).astype(np.int64)
    pemb = HostPSEmbedding(HostSparseTable(128, 4, seed=11, name="t"),
                           cache_slots=16, read_only=True, device="cpu")
    jemb = JEmb(JTable(128, 4, seed=11, name="t"), cache_slots=16,
                read_only=True)
    for _ in range(2):                     # cold, then cache hits
        got = CTRLookup(pemb, "ids", out_name="emb")({"ids": ids})["emb"]
        want = jfluid.serving.CTRLookup(jemb, "ids",
                                        out_name="emb")({"ids": ids})["emb"]
        assert isinstance(got, np.ndarray) and got.shape == (5, 12)
        np.testing.assert_array_equal(got, np.asarray(want))
    assert pemb.table.rows_initialized == 0


def test_fleet_names_raise_naming_item_10b():
    """Item 10-B is in: the six fleet names are exported as the JAX
    package exports them, and none of them raises any more."""
    names = ("FleetRouter", "FleetGiveUp", "ReplicaInfo", "FleetCTRView",
             "FleetManager", "autoscale_signal")
    from paddle_tpu_torch.serving import FleetRouter
    from paddle_tpu_torch.serving.router import FleetRouter as Direct

    assert FleetRouter is Direct
    for name in names:
        assert name in serving.__all__ and name in jfluid.serving.__all__
        assert callable(getattr(serving, name))
    assert set(jfluid.serving.__all__) <= set(serving.__all__)
    assert not hasattr(serving, "FLEET_NAMES")
    with pytest.raises(AttributeError):
        serving.NoSuchName  # noqa: B018


# ------------------------------------------------------ the reference's cases --

def test_engine_continuous_mixed_sizes_correct(artifact):
    rng = np.random.RandomState(2)
    ref = _ep(artifact)
    eng = ServeEngine(_ep(artifact), BucketLattice([4, 8]),
                      feed_spec=FEED_SPEC, name="serve_t1")
    with eng:
        sizes = [3, 1, 20, 2, 8, 5]
        reqs = [rng.rand(s, 12).astype("f4") for s in sizes]
        futs = [eng.submit({"x": x}) for x in reqs]
        outs = [fut.result(timeout=60) for fut in futs]
    s = eng.last_summary
    for x, (got,) in zip(reqs, outs):
        (want,) = ref.run({"x": x})
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert s["completed"] == len(sizes)
    assert s["admitted"] == s["evicted"] == len(sizes)
    assert s["recompiles"] == 0 and s["new_compiled_sigs"] == 0
    assert s["points"] == 2 and s["rows"] == sum(sizes)
    assert eng.precompile_sources["disk"] == 0


def test_engine_seq_buckets_pad_bit_exact(seq_artifact):
    rng = np.random.RandomState(3)
    ref = _ep(seq_artifact)
    lat = BucketLattice([2, 4], seq_buckets=[4, 8])
    eng = ServeEngine(_ep(seq_artifact), lat,
                      feed_spec={"x": ((serving.engine.SEQ,), "float32")},
                      name="serve_seq")
    with eng:
        cases = [rng.rand(3, 3).astype("f4"), rng.rand(1, 8).astype("f4"),
                 rng.rand(6, 5).astype("f4")]
        futs = [eng.submit({"x": x}, seq_len=x.shape[1]) for x in cases]
        for x, fut in zip(cases, futs):
            (got,) = fut.result(timeout=60)
            (want,) = ref.run({"x": x})
            assert got.shape[0] == x.shape[0]
            assert got.shape[1] == lat.route_seq(x.shape[1])
            np.testing.assert_array_equal(got[:, :x.shape[1]], want)
        with pytest.raises(RequestTooLarge):
            eng.submit({"x": rng.rand(2, 9).astype("f4")}, seq_len=9)
    assert eng.last_summary["recompiles"] == 0


def test_queue_admit_evict_ordering_slow_producer(artifact):
    rng = np.random.RandomState(4)
    eng = ServeEngine(_ep(artifact), BucketLattice([4, 8]),
                      feed_spec=FEED_SPEC, name="serve_slowprod")
    futs = []

    def producer():
        for _i in range(8):
            futs.append(eng.submit({"x": rng.rand(2, 12).astype("f4")}))
            time.sleep(0.02)

    with eng:
        t = threading.Thread(target=producer)
        t.start()
        t.join()
        for f in futs:
            f.result(timeout=60)
    ends = [f.t_done for f in futs]
    assert all(e is not None for e in ends) and ends == sorted(ends)
    s = eng.last_summary
    assert s["completed"] == 8 and s["admitted"] == 8 and s["evicted"] == 8
    assert s["backpressure"] == 0 and s["recompiles"] == 0


def test_small_request_not_stalled_behind_large(artifact):
    """A 1-row request submitted once a 400-row one is admitted completes
    BEFORE it in continuous mode, after it in static mode — and in steps:
    continuous serves it in its first step, static only after all 50 of
    the large one's."""
    rng = np.random.RandomState(5)
    big = rng.rand(400, 12).astype("f4")
    small = rng.rand(1, 12).astype("f4")
    order = {}
    for mode in ("static", "continuous"):
        eng = ServeEngine(_ep(artifact), BucketLattice([4, 8]),
                          feed_spec=FEED_SPEC, mode=mode,
                          name="serve_hol_%s" % mode)
        with eng:
            fb = eng.submit({"x": big})
            admitted = eng.stats.registry.counter(
                "serve_hol_%s.admitted" % mode)
            deadline = time.monotonic() + 10
            while admitted.value < 1 and time.monotonic() < deadline:
                time.sleep(0.001)
            fs = eng.submit({"x": small})
            fb.result(timeout=60)
            fs.result(timeout=60)
        order[mode] = (fb, fs)
    fb, fs = order["static"]
    assert fs.t_done > fb.t_done
    assert fs.first_step > fb.done_step
    assert fb.done_step - fb.first_step + 1 == 50
    fb, fs = order["continuous"]
    assert fs.t_done < fb.t_done
    assert fs.done_step == fs.first_step < fb.done_step


def test_read_only_cache_mode_never_writes():
    rng = np.random.RandomState(6)
    table = HostSparseTable(128, 4, seed=11, name="ro_table")
    emb = HostPSEmbedding(table, cache_slots=16, read_only=True,
                          device="cpu")
    ids = rng.randint(0, 128, size=(5, 3)).astype(np.int64)
    v1 = emb.pull(ids).numpy()
    want = HostSparseTable(128, 4, seed=11).pull(ids)
    np.testing.assert_array_equal(v1, want)
    assert table.rows_initialized == 0
    assert not table._live.any() and not table._param.any()
    for a in table._slots.values():
        assert not a.any()
    hits_before = emb.cache.hits
    v2 = emb.pull(ids).numpy()
    np.testing.assert_array_equal(v1, v2)
    assert emb.cache.hits > hits_before and table.rows_initialized == 0
    with pytest.raises(RuntimeError, match="read-only"):
        emb.push(np.array([1]), np.ones((1, 4), np.float32), 0.1)
    with pytest.raises(RuntimeError, match="read-only"):
        emb.push_in_jit(np.array([1]), np.ones((1, 4), np.float32), 0.1)
    with pytest.raises(ValueError, match="read-only"):
        CTRLookup(HostPSEmbedding(HostSparseTable(8, 2), device="cpu"), "ids")
    out = CTRLookup(emb, "ids", out_name="emb")({"ids": ids[:2]})
    assert out["emb"].shape == (2, 12) and "ids" not in out


@pytest.mark.parametrize("how", ["env", "configure"])
def test_admission_backpressure_under_tight_memscope_limit(
        artifact, monkeypatch, how):
    """Both arms of the limit (``PADDLE_TPU_MEMSCOPE_LIMIT`` and
    ``memscope.configure(bytes_limit=)``) refuse with Backpressure, and
    serving resumes once the limit is cleared and the 0.25 s verdict
    expired."""
    from paddle_tpu_torch.monitor import memscope

    eng = ServeEngine(_ep(artifact), BucketLattice([4]), feed_spec=FEED_SPEC,
                      name="serve_bp_%s" % how)
    try:
        with eng:
            if how == "env":
                monkeypatch.setenv("PADDLE_TPU_MEMSCOPE_LIMIT", "64")
            else:
                memscope.configure(bytes_limit=64)
            assert eng._need_bytes and eng._need_bytes > 64
            with pytest.raises(Backpressure):
                eng.submit({"x": np.zeros((2, 12), "f4")})
            assert eng.stats.registry.counter(
                "serve_bp_%s.backpressure" % how).value == 1
            monkeypatch.delenv("PADDLE_TPU_MEMSCOPE_LIMIT", raising=False)
            memscope.reset()
            time.sleep(0.3)
            eng.submit({"x": np.ones((2, 12), "f4")}).result(timeout=60)
        assert eng.last_summary["backpressure"] == 1
    finally:
        memscope.reset()


def test_engine_off_lattice_dispatch_trips_strict_gate(artifact):
    eng = ServeEngine(_ep(artifact), BucketLattice([4, 8]),
                      feed_spec=FEED_SPEC, name="serve_trip")
    with eng:
        eng._precompiled.discard((8, None))
        fut = eng.submit({"x": np.zeros((8, 12), "f4")})
        with pytest.raises(RecompileStorm):
            fut.result(timeout=60)
        assert isinstance(eng.error, RecompileStorm)
        with pytest.raises(ServeError, match="died"):
            eng.submit({"x": np.zeros((1, 12), "f4")})


def test_engine_rejects_malformed_request_without_dying(artifact):
    eng = ServeEngine(_ep(artifact), BucketLattice([4]), feed_spec=FEED_SPEC,
                      name="serve_malformed")
    with eng:
        with pytest.raises(ValueError, match="contract"):
            eng.submit({"wrong_name": np.zeros((2, 12), "f4")})
        with pytest.raises(ValueError, match="contract"):
            eng.submit({"x": np.zeros((2, 12), "f4"),
                        "extra": np.zeros((2, 3), "f4")})
        eng.submit({"x": np.ones((2, 12), "f4")}).result(timeout=60)
    assert eng.error is None and eng.last_summary["completed"] == 1


def test_engine_stop_fails_leftover_requests(artifact):
    eng = ServeEngine(_ep(artifact), BucketLattice([4]), feed_spec=FEED_SPEC,
                      name="serve_leftover")
    eng.start()
    futs = [eng.submit({"x": np.ones((2, 12), "f4")}) for _ in range(4)]
    eng.stop(drain=False)
    for f in futs:
        try:
            f.result(timeout=10)
        except ServeError:
            pass
        assert f.done()
    with pytest.raises(ServeError, match="one-shot"):
        eng.start()


def test_stats_summary_is_per_engine_despite_shared_prefix(artifact):
    for i in (1, 2):
        eng = ServeEngine(_ep(artifact), BucketLattice([4]),
                          feed_spec=FEED_SPEC, name="serve_shared")
        with eng:
            for _ in range(i):
                eng.submit({"x": np.ones((2, 12), "f4")}).result(timeout=60)
        assert eng.last_summary["admitted"] == i
        assert eng.last_summary["evicted"] == i


def test_trace_summary_serve_section(artifact, tmp_path):
    """``scripts/trace_summary.py``'s serve section reads a port monitor
    directory unchanged: the same event names and fields."""
    out_dir = str(tmp_path / "mon")
    pmon.enable(out_dir)
    try:
        eng = ServeEngine(_ep(artifact), BucketLattice([4, 8]),
                          feed_spec=FEED_SPEC, name="serve_ts")
        rng = np.random.RandomState(7)
        with eng:
            futs = [eng.submit({"x": rng.rand(s, 12).astype("f4")})
                    for s in (1, 6, 3)]
            for f in futs:
                f.result(timeout=60)
    finally:
        pmon.disable()
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "trace_summary.py"),
         "--timeline", out_dir, "--json"],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, (r.stdout, r.stderr)
    sv = json.loads(r.stdout.splitlines()[-1]).get("serve")
    assert sv and sv["steps"] >= 1 and sv["recompiles"] == 0
    assert sv["modes"]["continuous"]["completed"] == 3
    assert sv["modes"]["continuous"]["p99_ms"] is not None
    assert sv["engines"]["continuous"]["points"] == 2
    events = pmon.read_events(os.path.join(out_dir, "timeline.jsonl"))
    kinds = {e.get("ev") for e in events}
    assert {"serve_start", "serve", "serve_request", "serve_summary"} <= kinds
    stages = [e["stages"] for e in events if e.get("ev") == "serve_request"]
    assert len(stages) == 3 and all(
        set(s) == {"admit", "queue_wait", "assemble", "device", "reply"}
        for s in stages)


# --------------------------------------------- engine swaps (test_online) --

def test_swap_mid_trace_strands_no_futures_single_summary(artifact,
                                                          tmp_path):
    out_dir = str(tmp_path / "mon")
    pmon.enable(out_dir)
    try:
        rng = np.random.RandomState(3)
        ep = _ep(artifact)
        eng = ServeEngine(ep, BucketLattice([4, 8]), feed_spec=FEED_SPEC,
                          name="swap_t1")
        doubled = {n: v * 2.0 for n, v in ep._state.items()}
        with eng:
            big = eng.submit({"x": rng.rand(300, 12).astype("f4")})
            while eng.stats.registry.counter("swap_t1.admitted").value < 1:
                time.sleep(0.001)
            ev = eng.request_swap(lambda: ep.swap_state(doubled) and None,
                                  version=2, timeout=60)
            after = [eng.submit({"x": rng.rand(3, 12).astype("f4")})
                     for _ in range(4)]
            (big_out,) = big.result(timeout=60)
            outs = [f.result(timeout=60) for f in after]
        assert eng.version == 2 and ev["version"] == 2
        assert ev["stall_ms"] >= 0 and ev["apply_ms"] >= 0
        assert big_out.shape == (300, 1)
        ref = _ep(artifact)
        ref.swap_state(doubled)
        for f, (got,) in zip(after, outs):
            (want,) = ref.run({"x": f.feed["x"]})
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        s = eng.last_summary
        assert s["completed"] == 5 and s["recompiles"] == 0
        assert s["new_compiled_sigs"] == 0
    finally:
        pmon.disable()
    events = pmon.read_events(os.path.join(out_dir, "timeline.jsonl"))
    summaries = [e for e in events if e.get("ev") == "serve_summary"
                 and e.get("ident", "").startswith("swap_t1")]
    flips = [e for e in events if e.get("ev") == "serve_flip"
             and e.get("ident", "").startswith("swap_t1")]
    assert len(summaries) == 1 and len(flips) == 1
    assert flips[0]["version"] == 2


def test_failed_swap_apply_keeps_old_version_serving(artifact):
    eng = ServeEngine(_ep(artifact), BucketLattice([4]), feed_spec=FEED_SPEC,
                      name="swap_fail")

    def boom():
        raise RuntimeError("poisoned publish")

    with eng:
        with pytest.raises(RuntimeError, match="poisoned"):
            eng.request_swap(boom, version=9, timeout=60)
        assert eng.version is None and eng.error is None
        eng.submit({"x": np.ones((2, 12), "f4")}).result(timeout=60)
    assert eng.last_summary["completed"] == 1


def test_swap_refused_when_not_serving_or_already_pending(artifact):
    eng = ServeEngine(_ep(artifact), BucketLattice([4]), feed_spec=FEED_SPEC,
                      name="swap_refuse")
    with pytest.raises(ServeError, match="not serving"):
        eng.request_swap(lambda: None, version=1)
    results = []
    rng = np.random.RandomState(8)
    with eng:
        big = eng.submit({"x": rng.rand(400, 12).astype("f4")})
        while eng.stats.registry.counter("swap_refuse.admitted").value < 1:
            time.sleep(0.001)
        t = threading.Thread(target=lambda: results.append(
            eng.request_swap(lambda: None, version=1, timeout=60)))
        t.start()
        while eng._swap is None and not results:
            time.sleep(0.001)
        assert eng._swap is not None
        with pytest.raises(ServeError, match="already pending"):
            eng.request_swap(lambda: None, version=2)
        big.result(timeout=60)
        t.join()
    assert results and results[0]["version"] == 1
    with pytest.raises(ServeError, match="one-shot"):
        eng.start()


def test_swap_state_refuses_signature_change(artifact):
    ep = _ep(artifact)
    good = {n: v + 1.0 for n, v in ep._state.items()}
    assert ep.swap_state(good) == len(good)
    name = next(iter(good))
    with pytest.raises(ValueError, match="signature"):
        ep.swap_state({**good, name: np.zeros((1, 1), np.float32)})
    with pytest.raises(KeyError, match="missing"):
        ep.swap_state({})


# ------------------------------------------------------------ the canary --

class _FakeRouter:
    def __init__(self, want):
        self.answer = np.asarray(want)
        self.versions = {0: 1, 1: 1}

    def submit(self, feed):
        return [self.answer]

    def snapshot(self):
        return {rid: {"version": v, "depth": 0, "outstanding": 0}
                for rid, v in self.versions.items()}


def test_canary_known_answer_and_version_skew(tmp_path):
    from paddle_tpu_torch.monitor import timeline as timeline_mod
    from paddle_tpu_torch.serving.canary import CanaryProber

    want = np.arange(4.0, dtype=np.float32)
    router = _FakeRouter(want)
    reg = StatRegistry()
    tl = timeline_mod.Timeline(str(tmp_path / "timeline.jsonl"))
    canary = CanaryProber(router, [({"x": want}, want)], registry=reg,
                          timeline=tl)
    rec = canary.probe_once()
    assert rec["ok"] and rec["trace_id"]
    assert reg.gauge("canary.ok").value == 1.0
    assert rec["version_skew"] == 0
    router.answer = want + 0.5
    router.versions[1] = 2
    rec = canary.probe_once()
    assert not rec["ok"] and "known-answer mismatch" in rec["error"]
    assert rec["version_skew"] == 1
    assert reg.gauge("canary.ok").value == 0.0
    assert reg.gauge("canary.consecutive_failures").value == 1.0
    assert canary.probes_sent == 2 and canary.failures == 1
    probes = timeline_mod.read_events(tl.path, ev="canary_probe")
    assert probes[-1]["ok"] is False
    assert probes[-1]["trace_id"] == rec["trace_id"]
    tl.close()
    with pytest.raises(ValueError):
        CanaryProber(router, [])


# -------------------------------------------------------------- the shield --

def test_retry_budget_earn_spend_refund():
    from paddle_tpu_torch.serving.shield import RetryBudget

    b = RetryBudget(ratio=0.5, cap=2.0, seed=1.0)
    assert b.tokens == 1.0
    assert b.try_spend()
    assert not b.try_spend()
    assert (b.spent, b.denied) == (1, 1)
    for _ in range(10):
        b.observe()
    assert b.tokens == 2.0
    assert b.try_spend() and b.try_spend() and not b.try_spend()
    b.refund()
    assert b.tokens == 1.0 and b.spent == 2
    snap = b.snapshot()
    assert snap["denied"] == 2 and snap["ratio"] == 0.5


def test_replica_breaker_trip_cooloff_probe_cycle():
    from paddle_tpu_torch.serving.shield import ReplicaBreaker

    br = ReplicaBreaker(trip_ms=100.0, cooloff_s=2.0, min_samples=3)
    now = 1000.0
    for _ in range(4):
        br.record(10.0, False, now)
    assert br.state == br.CLOSED and br.admit(now) is True
    for _ in range(8):
        br.record(400.0, False, now)
    assert br.state == br.OPEN and br.trips == 1
    assert br.admit(now + 1.0) is False
    assert br.admit(now + 2.5) == "probe"
    assert br.admit(now + 2.6) == "probe"
    br.record(12.0, False, now + 3.0)
    assert br.state == br.CLOSED
    assert br.lat_ms == 12.0 and br.n == 1
    for _ in range(8):
        br.record(400.0, False, now + 4.0)
    assert br.admit(now + 7.0) == "probe"
    br.record(400.0, False, now + 7.1)
    assert br.state == br.OPEN and br.trips == 2


def test_shed_policy_priority_scaling():
    from paddle_tpu_torch.serving.shield import ShedPolicy

    assert ShedPolicy().verdict(0, 1e9) is None
    p = ShedPolicy(watermark=2.0, retry_after_ms=75.0)
    assert p.verdict(0, 2.5) == 75.0
    assert p.verdict(1, 2.5) is None
    assert p.verdict(1, 4.5) == 75.0
    assert p.verdict(2, 4.5) is None
    assert p.verdict(2, 8.5) == 75.0
    assert p.sheds == 3
    assert p.verdict(-3, 1.5) is None and p.verdict(99, 7.0) is None


def test_shield_config_inert_defaults():
    from paddle_tpu_torch.serving.shield import ShieldConfig

    cfg = ShieldConfig()
    assert cfg.make_breaker() is None
    assert cfg.make_shed().watermark is None
    armed = ShieldConfig(breaker_trip_ms=150.0)
    assert armed.make_breaker() is not None


def test_shield_decisions_match_the_jax_package():
    """The same inputs through both packages' shield give the same
    decisions (the module is a copy)."""
    from paddle_tpu.serving import shield as jsh
    from paddle_tpu_torch.serving import shield as psh

    rng = np.random.RandomState(9)
    pb = psh.ReplicaBreaker(trip_ms=100.0, cooloff_s=1.0, min_samples=3)
    jb = jsh.ReplicaBreaker(trip_ms=100.0, cooloff_s=1.0, min_samples=3)
    ps, js = psh.ShedPolicy(watermark=2.0), jsh.ShedPolicy(watermark=2.0)
    for k in range(200):
        now, ms, err = 100.0 + 0.1 * k, float(rng.exponential(80)), \
            bool(rng.rand() < 0.1)
        assert pb.admit(now) == jb.admit(now)
        pb.record(ms, err, now)
        jb.record(ms, err, now)
        assert (pb.state, pb.trips) == (jb.state, jb.trips)
        prio, load = int(rng.randint(0, 3)), float(rng.rand() * 10)
        assert ps.verdict(prio, load) == js.verdict(prio, load)


# ------------------------------------------------------------ serve_bench --

def test_deepfm_artifact_serves_the_deepfm_head_in_both_packages(tmp_path):
    """``serve_bench``'s DeepFM artifact (one feed ``emb`` [B, F * (D + 1)])
    built by ``build_deepfm_program`` in each package with one
    ``init_dense`` tree and exported by its own package: both packages'
    continuous engines
    serve the same looked-up rows within the serving tolerance of each
    other, the port's within the derived bound of ``_deepfm_head``; the
    port's engine behind a read-only ``CTRLookup`` gives the same bits as
    its engine fed those rows."""
    from paddle_tpu_torch.tools import deepfm_hostps as dh
    from paddle_tpu_torch.tools import serve_bench as sb

    F, D, mlp, vocab = 4, 3, (8, 8), 5000
    dense = dh.init_dense(torch.Generator().manual_seed(3), F, D, mlp, "cpu")
    params = sb.deepfm_params(dense)
    assert sorted(params) == sorted(
        ["deepfm_mlp_%d.%s" % (i, k) for i in range(3) for k in "wb"]
        + ["deepfm_bias"])
    pdir, jdir = str(tmp_path / "p"), str(tmp_path / "j")
    sb.build_deepfm_artifact(pfluid, pdir, params, F, D, mlp, device="cpu")
    sb.build_deepfm_artifact(jfluid, jdir, params, F, D, mlp)
    table, _emb, lookup = sb.make_deepfm_lookup(vocab, D, 16, device="cpu")
    trace = sb.deepfm_trace(15, 32, np.random.RandomState(4), F, vocab)
    feeds = [lookup(dict(t)) for t in trace]
    spec = {"emb": ((F * (D + 1),), "float32")}
    lattice = [2, 4, 8]

    def serve(pkg, ep, reqs, lookups=()):
        eng = pkg.serving.ServeEngine(ep, pkg.serving.BucketLattice(lattice),
                                      feed_spec=spec, lookups=list(lookups),
                                      name="deepfm_%s" % pkg.__name__)
        with eng:
            futs = [eng.submit(dict(r)) for r in reqs]
            return [np.asarray(f.result(timeout=120)[0]) for f in futs]

    pout = serve(pfluid, _ep(pdir), feeds)
    jout = serve(jfluid, jfluid.inference.load_exported_model(jdir), feeds)
    looked = serve(pfluid, _ep(pdir), trace, [lookup])
    for t, f, got, want, lk in zip(trace, feeds, pout, jout, looked):
        assert got.shape == want.shape == (len(t["ids"]),)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(lk, got)
        ref, bound = sb.deepfm_head_bounds(
            dense, f["emb"].reshape(-1, F, D + 1), D)
        assert sb._hold(got, ref, bound)["ok"]
    assert table.rows_initialized == 0


def test_serve_bench_profiles_the_static_lookups():
    """``--profile-lookups``' body at a small table: the trace's requests
    in chunks of the largest bucket, a cold pass then a warm one."""
    from paddle_tpu_torch.tools import serve_bench as sb

    cfg = dict(sb.FULL, vocab=5000, fields=4, dim=3, cache_slots=64)
    cold, warm, chunks = sb.profile_lookups(
        cfg, torch.device("cpu"), np.random.RandomState(0), 10)
    # every 5th request (2 of 10) is 4 x 64 rows: 4 chunks each
    assert chunks == 8 + 2 * 4
    assert cold > 0 and warm > 0


def test_serve_bench_smoke_gate():
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.serve_bench",
         "--smoke", "--check", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    lines = [json.loads(l) for l in r.stdout.splitlines()
             if l.startswith("{")]
    assert [l["mode"] for l in lines] == ["static", "continuous"]
    for l in lines:
        assert l["recompiles"] == 0 and l["new_compiled_sigs"] == 0
        assert l["head_of_line"]["violations"] == []
        assert l["verified"] >= 13
    assert lines[0]["precompile_sources"]["compiled"] == 3
    assert lines[1]["precompile_sources"]["cached"] == 3
    assert "serve_bench: PASS" in r.stdout
