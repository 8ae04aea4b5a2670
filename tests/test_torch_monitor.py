"""The port's monitor (``paddle_tpu_torch/monitor``) against the JAX
package's on the CPU: the copied modules give the reference's outputs
(Prometheus text, timeline round trip and torn lines, histogram
quantiles); the recompile detector fires once per plan-cache miss of the
port's executor; a monitored Fluid run writes the reference's files, field
for field, and ``scripts/trace_summary.py`` reads them unchanged; an
uncaught exception leaves ``postmortem.json``."""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu import monitor as jmon
from paddle_tpu_torch import monitor as pmon


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_monitors():
    for m in (jmon, pmon):
        m.disable()
        m.default_registry().reset()
    yield
    for m in (jmon, pmon):
        m.disable()
        m.default_registry().reset()


def _fill(mod):
    reg = mod.StatRegistry()
    reg.counter("hostps.cache.hit", table="emb0").incr(12)
    reg.counter("monitor.compile").incr(3)
    reg.gauge("hostps.cache.occupancy").set(0.5)
    reg.gauge("monitor.mem.owner_bytes", owner="scope").set(1234)
    h = reg.histogram("serve.latency_ms")
    for i in range(1, 1001):
        h.observe(float(i) * 0.37)
    reg.histogram("wire.ms", shard="3").observe(7.0)
    reg.histogram("empty.hist")
    return reg


def test_same_stats_give_the_same_prometheus_text(tmp_path):
    jtext = jmon.to_prometheus_text(_fill(jmon))
    ptext = pmon.to_prometheus_text(_fill(pmon))
    assert ptext == jtext
    assert pmon.parse_prometheus_text(ptext) == jmon.parse_prometheus_text(jtext)
    p = pmon.write_prometheus(str(tmp_path / "m.prom"), _fill(pmon))
    assert open(p).read() == jtext


def test_histogram_quantiles_match_the_reference():
    jh = _fill(jmon).histogram("serve.latency_ms")
    ph = _fill(pmon).histogram("serve.latency_ms")
    assert ph.quantiles() == jh.quantiles()
    assert len(ph._samples) == len(jh._samples) < ph.SAMPLE_CAP


def test_timeline_round_trip_and_torn_lines(tmp_path):
    mon = pmon.enable(str(tmp_path / "run"))
    mon.record_step(0, host_ms=1.5, device_ms=3.0, batch=16, fetches=2)
    mon.record_step(1, host_ms=1.0, batch=16)
    mon.timeline.emit("custom", tag="x")
    pmon.disable()
    path = str(tmp_path / "run" / "timeline.jsonl")
    with open(path, "a") as f:
        f.write("[1, 2, 3]\n")                       # parses, not an event
        f.write('{"ev": "step", "ts": 3.0, "st')     # killed mid-write
    for ev in (None, "step"):
        assert pmon.read_events(path, ev=ev, with_torn=True) == \
            jmon.read_events(path, ev=ev, with_torn=True)
    events, torn = pmon.read_events(path, with_torn=True)
    assert torn == 2
    steps = [e for e in events if e["ev"] == "step"]
    assert [e["step"] for e in steps] == [0, 1]
    assert steps[0]["examples_per_sec"] == pytest.approx(16 / 0.003)
    assert (tmp_path / "run" / "metrics.prom").exists()


def _mlp(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[8], dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        pred = fluid.layers.fc(fluid.layers.fc(x, 16, act="relu"), 4,
                               act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, y))
        fluid.optimizer.Adam(1e-2).minimize(loss)
    return main, startup, loss


def _batch(i, n=16):
    rng = np.random.RandomState(i)
    xs = rng.randn(n, 8).astype(np.float32)
    return {"x": xs, "y": (np.abs(xs[:, :1] * 3).astype(np.int64) % 4)}


def test_recompile_detector_fires_once_per_plan_cache_miss(tmp_path):
    main, startup, loss = _mlp(pfluid)
    exe = pfluid.Executor(pfluid.CPUPlace())
    scope = pfluid.Scope()
    exe.run(startup, scope=scope)
    mon = pmon.enable(str(tmp_path))
    det = mon.recompiles
    exe.run(main, feed=_batch(0, 16), fetch_list=[loss], scope=scope)
    ident = det.events[-1]["ident"]
    base = len(det.events)
    for _ in range(3):                                  # plan-cache hits
        exe.run(main, feed=_batch(0, 16), fetch_list=[loss], scope=scope)
    assert len(det.events) == base
    exe.run(main, feed=_batch(1, 8), fetch_list=[loss], scope=scope)
    assert len(det.events) == base + 1
    ev = det.events[-1]
    assert ev["recompile"] is True and ev["ident"] == ident
    assert ev["diff"] == ["feed"]
    exe.run(main, feed=_batch(2, 16), fetch_list=[loss], scope=scope)
    exe.run(main, feed=_batch(3, 8), fetch_list=[loss], scope=scope)
    assert len(det.events) == base + 1 and det.recompiles(ident) == 1
    exe.run(main, feed=_batch(0, 16), fetch_list=[loss], scope=scope,
            use_program_cache=False)
    assert len(det.events) == base + 1
    assert mon.registry.counter("monitor.compile.uncached").value == 1


def test_recompile_detector_warns_after_n_plan_rebuilds(tmp_path):
    main, startup, loss = _mlp(pfluid)
    exe = pfluid.Executor(pfluid.CPUPlace())
    scope = pfluid.Scope()
    exe.run(startup, scope=scope)
    pmon.enable(str(tmp_path), warn_after_recompiles=2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for n in (4, 5, 6, 7):                      # four plans, 3 rebuilds
            exe.run(main, feed=_batch(n, n), fetch_list=[loss], scope=scope)
    hits = [w for w in caught if "recompiled 2 times" in str(w.message)]
    assert len(hits) == 1


def _monitored_runs(fluid, mon_mod, out_dir, steps=6):
    main, startup, loss = _mlp(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    mon_mod.enable(out_dir)
    for i in range(steps):
        exe.run(main, feed=_batch(i), fetch_list=[loss], scope=scope)
    mon_mod.disable()


def test_a_monitored_run_writes_the_reference_files(tmp_path):
    """The same program under each package's monitor: the files exist, and
    each event the port writes carries the reference's fields (a plan's
    ledger has no XLA code or alias bytes, and no temp bytes without the
    card's allocator); every Prometheus metric the port writes is one the
    reference writes."""
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    _monitored_runs(pfluid, pmon, pdir)
    _monitored_runs(jfluid, jmon, jdir)
    for name in ("timeline.jsonl", "trace.json", "metrics.prom", "clock.json"):
        assert os.path.exists(os.path.join(pdir, name)), name

    def by_ev(d):
        out = {}
        for e in jmon.read_events(os.path.join(d, "timeline.jsonl")):
            out.setdefault(e["ev"], []).append(e)
        return out

    pev, jev = by_ev(pdir), by_ev(jdir)
    assert len(pev["step"]) == len(jev["step"]) == 6
    for ev in ("step", "compile", "monitor_start", "monitor_end",
               "mem_program"):
        for p, j in zip(pev[ev], jev[ev]):
            assert set(p) <= set(j), (ev, set(p) - set(j))
            absent = ({"temp_bytes", "generated_code_bytes", "alias_bytes"}
                      if ev == "mem_program" else set())
            assert set(j) - set(p) <= absent, (ev, set(j) - set(p))
    assert [e.get("compiled", False) for e in pev["step"]] == \
        [e.get("compiled", False) for e in jev["step"]]
    assert [("device_ms" in e) for e in pev["step"]] == \
        [("device_ms" in e) for e in jev["step"]]
    assert {e["source"] for e in pev["mem_program"]} == {"compile"}
    pnames = set(pmon.parse_prometheus_file(os.path.join(pdir, "metrics.prom")))
    jnames = set(jmon.parse_prometheus_file(os.path.join(jdir, "metrics.prom")))
    strip = {n.split("{")[0] for n in jnames}
    assert {n.split("{")[0] for n in pnames} <= strip
    with open(os.path.join(pdir, "trace.json")) as f:
        spans = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"executor.run", "executor.feed_convert", "executor.compile",
            "executor.dispatch", "executor.device_sync"} <= spans


def test_trace_summary_reads_a_port_directory(tmp_path):
    d = str(tmp_path / "port")
    _monitored_runs(pfluid, pmon, d, steps=9)
    r = subprocess.run([sys.executable, os.path.join(ROOT, "scripts",
                                                     "trace_summary.py"),
                        "--timeline", d, "--json"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert summary["steps"] == 9 and summary["compile_steps"] == 1
    assert summary["device_ms"]["n"] >= 1
    assert summary["phases"]["compute"]["n"] == 8


def test_an_uncaught_exception_leaves_a_postmortem(tmp_path):
    d = str(tmp_path / "crash")
    code = """
import numpy as np
import paddle_tpu_torch as fluid
from paddle_tpu_torch import monitor
monitor.enable(%r)
main, startup = fluid.Program(), fluid.Program()
with fluid.program_guard(main, startup):
    x = fluid.layers.data("x", shape=[4], dtype="float32")
    loss = fluid.layers.mean(fluid.layers.fc(x, 2))
    fluid.optimizer.SGD(0.1).minimize(loss)
exe = fluid.Executor(fluid.CPUPlace())
exe.run(startup)
exe.run(main, feed={"x": np.ones((3, 4), "f4")}, fetch_list=[loss])
raise ValueError("boom after one step")
""" % d
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode != 0 and "boom after one step" in r.stderr
    with open(os.path.join(d, "postmortem.json")) as f:
        post = json.load(f)
    assert post["reason"] == "sys.excepthook"
    assert "boom after one step" in json.dumps(post["exception"])
    assert any(e.get("ev") == "step" for e in post["timeline_tail"])
