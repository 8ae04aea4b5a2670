"""The port's MemScope (``paddle_tpu_torch/monitor/memscope.py``) through
its executor on the CPU: a ledger per plan (measured on the plan's first
run, ``source="compile"``), owner attribution of the scope, refuse mode's
``MemoryBudgetError`` before the dispatch, the ``oom_step`` drill's one
postmortem with its memory section, and a best-effort snapshot with no
owners."""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import monitor as pmon
from paddle_tpu_torch.ft import chaos
from paddle_tpu_torch.monitor import memscope


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    pmon.disable()
    memscope.reset()
    chaos.disarm()
    yield
    pmon.disable()
    memscope.reset()
    chaos.disarm()


def _setup(tmp_path):
    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.unique_name.guard(), pfluid.program_guard(main, startup):
        x = pfluid.layers.data("x", shape=[8], dtype="float32")
        loss = pfluid.layers.mean(pfluid.layers.fc(
            pfluid.layers.fc(x, 32, act="relu"), 4))
        pfluid.optimizer.Adam(1e-2).minimize(loss)
    exe = pfluid.Executor(pfluid.CPUPlace())
    scope = pfluid.Scope()
    exe.run(startup, scope=scope)
    mon = pmon.enable(str(tmp_path))
    return mon, main, exe, scope, loss


def _feed(n=16):
    return {"x": np.random.RandomState(n).randn(n, 8).astype(np.float32)}


def _state(main, scope):
    return {v.name: scope.find_tensor_as_numpy(v.name)
            for v in main.list_vars() if v.persistable}


def test_a_ledger_per_plan_from_its_first_run(tmp_path):
    mon, main, exe, scope, loss = _setup(tmp_path)
    for n in (16, 16, 8, 16, 8):
        exe.run(main, feed=_feed(n), fetch_list=[loss], scope=scope)
    mon.timeline.flush()
    events = pmon.read_events(os.path.join(str(tmp_path), "timeline.jsonl"),
                              ev="mem_program")
    assert len(events) == 2                            # two plans, two ledgers
    assert {e["source"] for e in events} == {"compile"}
    state_bytes = sum(a.nbytes for a in _state(main, scope).values())
    for e, n in zip(events, (16, 8)):
        assert e["available"] is True
        assert e["argument_bytes"] == state_bytes + n * 8 * 4
        assert e["output_bytes"] >= state_bytes
    ident = events[0]["ident"]
    assert memscope.ledgers()[-1][0] == ident
    assert mon.registry.gauge("monitor.mem.program.argument_bytes",
                              program=ident).value == events[1]["argument_bytes"]


def test_owner_attribution_classifies_the_scope(tmp_path):
    mon, main, exe, scope, loss = _setup(tmp_path)
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    held = torch.zeros(1000)
    memscope.register_owner("cache", lambda: [held, held[10:]])
    attr = memscope.attribution()
    scope_bytes = sum(a.nbytes for a in _state(main, scope).values())
    assert attr["owners"]["scope"] >= scope_bytes
    assert attr["owners"]["cache"] == 4000              # the view counts once
    assert attr["owners"]["unattributed"] == 0          # no allocator on the CPU
    snap = mon.maybe_sample_memory(force=True)
    assert snap["owners"]["cache"] == 4000 and "devices" not in snap
    assert mon.registry.gauge("monitor.mem.owner_bytes", owner="cache").value \
        == 4000


def test_refuse_mode_raises_before_the_dispatch(tmp_path):
    mon, main, exe, scope, loss = _setup(tmp_path)
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)   # measured
    before = _state(main, scope)
    memscope.configure(bytes_limit=1024, refuse=True)
    for _ in range(2):                                  # stays armed
        with pytest.raises(memscope.MemoryBudgetError, match="headroom"):
            exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    after = _state(main, scope)
    assert all(np.array_equal(before[n], after[n]) for n in before)
    assert mon.registry.counter("monitor.mem.predicted_oom").value == 2
    memscope.configure(bytes_limit=1 << 40)
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)


def test_the_oom_step_drill_leaves_one_postmortem(tmp_path):
    mon, main, exe, scope, loss = _setup(tmp_path)
    chaos.arm("oom_step", at=2)
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    with pytest.raises(memscope.InjectedOOMError):
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    posts = [f for f in os.listdir(str(tmp_path)) if f.startswith("postmortem")]
    assert posts == ["postmortem.json"]
    with open(os.path.join(str(tmp_path), "postmortem.json")) as f:
        post = json.load(f)
    assert post["reason"] == "resource_exhausted"
    sec = post["mem_oom"]
    assert sec["failing_program"] and sec["ledger"]["argument_bytes"] > 0
    assert sec["owners_top"][0]["owner"] == "scope"
    assert mon.registry.counter("monitor.mem.oom").value == 1
    assert memscope.is_resource_exhausted(torch.cuda.OutOfMemoryError("x"))


def test_the_snapshot_is_best_effort_with_no_owners():
    snap = pmon.memory_snapshot()
    assert "devices" not in snap and snap["host"]["rss_bytes"] > 0
    assert snap["owners"]["unattributed"] == 0
    assert memscope.headroom()["cpu"]["headroom"] is None
    memscope.configure(bytes_limit=10 ** 9)
    h = memscope.headroom()["cpu"]
    assert h["estimated"] and h["headroom"] == 10 ** 9 - h["bytes_in_use"]
