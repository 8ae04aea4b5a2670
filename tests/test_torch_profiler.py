"""The port's ``profiler.py`` (``torch.profiler`` behind the Fluid profiler
API) in the JAX package's five cases (``tests/test_profiler.py``), on the
CPU: the table and the chrome trace, the sort keys, the unknown key's
error, the counter report's columns, and the counters as views of the
monitor registry."""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import profiler as prof


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_profiler_table_and_timeline(tmp_path):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[32], dtype="float32")
        h = fluid.layers.fc(x, 64, act="relu")
        loss = fluid.layers.mean(fluid.layers.fc(h, 8))
        fluid.optimizer.SGD(0.1).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    xs = np.random.RandomState(0).rand(16, 32).astype("f4")
    exe.run(main, feed={"x": xs}, fetch_list=[loss.name], scope=scope)

    chrome = str(tmp_path / "timeline.json")
    prof.start_profiler("All", trace_dir=str(tmp_path / "capture"))
    with prof.RecordEvent("custom_region"):
        for _ in range(3):
            exe.run(main, feed={"x": xs}, fetch_list=[loss.name], scope=scope)
    rows = prof.stop_profiler(sorted_key="total", profile_path=chrome)

    assert rows, "profiler table is empty"
    names = {r["name"] for r in rows}
    assert any("custom_region" in n for n in names), sorted(names)[:20]
    assert any(r["total_ms"] > 0 for r in rows)
    assert any(n.startswith("aten::") for n in names)
    totals = [r["total_ms"] for r in rows]
    assert totals == sorted(totals, reverse=True)
    with open(chrome) as f:
        tr = json.load(f)
    assert tr.get("traceEvents")


def test_aggregate_sort_keys(tmp_path):
    td = str(tmp_path)
    prof.start_profiler(trace_dir=td)
    (torch.ones((64, 64)) @ torch.ones((64, 64))).sum()
    prof.stop_profiler()
    for key, field in (("calls", "calls"), ("max", "max_ms"), ("ave", "avg_ms")):
        rows = prof.aggregate_profile(td, key)
        assert rows
        vals = [r[field] for r in rows]
        assert vals == sorted(vals, reverse=True)
    mins = [r["min_ms"] for r in prof.aggregate_profile(td, "min")]
    assert mins == sorted(mins, reverse=True)


def test_aggregate_unknown_sort_key_raises():
    with pytest.raises(ValueError, match="total.*calls.*max.*min.*ave"):
        prof.aggregate_profile("/nonexistent", "avg")
    with pytest.raises(ValueError):
        prof.aggregate_profile("/nonexistent", "Total")


def test_counter_report_column_alignment(capsys):
    prof.reset_profiler()
    prof.incr("plain_counter", 42)
    prof.observe("latency", 2.0)
    prof.observe("latency", 4.0)
    prof._print_counter_report(prof.counter_report())
    out = capsys.readouterr().out.splitlines()
    header = next(l for l in out if "Value" in l and "Calls" in l)
    assert header.index("Value") < header.index("Calls")

    def col_end(label):
        return header.index(label) + len(label)

    crow = next(l for l in out if l.startswith("plain_counter"))
    assert crow.rstrip().endswith("42")
    assert len(crow.rstrip()) == col_end("Value")
    orow = next(l for l in out if l.startswith("latency"))
    for label, want in (("Calls", "2"), ("Total", "6.000"),
                        ("Avg", "3.0000"), ("Min", "2.0000"),
                        ("Max", "4.0000")):
        assert orow[:col_end(label)].rstrip().endswith(want), (label, orow)
    prof.reset_profiler()


def test_counters_unify_with_monitor_registry():
    from paddle_tpu_torch import monitor

    prof.reset_profiler()
    prof.incr("unified.counter", 5)
    assert monitor.default_registry().counter("unified.counter").value == 5
    monitor.default_registry().counter("unified.counter").incr(2)
    assert prof.counters()["unified.counter"] == 7
    kinds = {r["name"]: r["kind"] for r in prof.counter_report()}
    assert kinds["unified.counter"] == "counter"
    prof.reset_profiler()
    assert "unified.counter" not in prof.counters()
