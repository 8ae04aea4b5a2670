"""Failure detection (``distributed/heartbeat.py``, ROADMAP item 5-B) held to
the JAX package's: ``tests/test_failure_detection.py``'s scenarios run on
both packages side by side, each on its own temporary directory, and the
states read at the same moments must agree.  ``Executor.close()`` marks the
worker complete (the reference's Close -> SendComplete), and
``WorkerHeartbeat(agree_dir=...)`` raises until the port has ``ft/agree.py``
(item 6).
"""

import os
import time

import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu.distributed import heartbeat as jhb
from paddle_tpu_torch.distributed import heartbeat as phb

PACKAGES = {"jax": jhb, "port": phb}


def _dirs(tmp_path):
    out = {}
    for name in PACKAGES:
        d = tmp_path / name
        d.mkdir()
        out[name] = str(d)
    return out


def test_monitor_states_match_the_reference(tmp_path):
    """Both workers beat: RUNNING; one completes and the other's beats stop
    (a simulated crash): COMPLETED and LOST, and lost_workers says which."""
    dirs = _dirs(tmp_path)
    mons, workers = {}, {}
    for name, hb in PACKAGES.items():
        mons[name] = hb.HeartBeatMonitor(dirs[name], n_workers=2, timeout=1.0,
                                         interval=0.2).start()
        workers[name] = [hb.WorkerHeartbeat(dirs[name], r, interval=0.2).start()
                         for r in range(2)]
    time.sleep(0.5)
    first = {name: m.worker_status() for name, m in mons.items()}
    assert first["port"] == first["jax"] == {0: jhb.RUNNING, 1: jhb.RUNNING}
    for name in PACKAGES:
        workers[name][0].complete()
        workers[name][1]._stop.set()
    time.sleep(1.6)
    second = {name: m.worker_status() for name, m in mons.items()}
    assert second["port"] == second["jax"] == {0: jhb.COMPLETED, 1: jhb.LOST}
    assert mons["port"].lost_workers() == mons["jax"].lost_workers() == [1]
    assert not mons["port"].all_completed()
    for m in mons.values():
        m.stop()
    assert sorted(os.listdir(dirs["port"])) == sorted(os.listdir(dirs["jax"]))


def test_liveness_and_stale_rank_sweep_match_the_reference(tmp_path):
    dirs = _dirs(tmp_path)
    got = {}
    for name, hb in PACKAGES.items():
        d = dirs[name]
        for r in range(4):
            with open(os.path.join(d, "hb-%d" % r), "w") as f:
                f.write("1 0.0 1 0")
        open(os.path.join(d, "done-3"), "w").close()
        probes = [hb.RankLiveness(d, r, timeout=5.0) for r in (0, 3, 7)]
        got[name] = ([p.alive() for p in probes],
                     hb.clear_stale_ranks(d, 2), sorted(os.listdir(d)),
                     hb.RankLiveness(None, 0).alive())
    assert got["port"] == got["jax"]
    assert got["port"][0] == [True, False, False]
    assert got["port"][1] == [2, 3]


def test_executor_close_marks_the_worker_complete(tmp_path):
    """``tests/test_failure_detection.py::test_executor_close_marks_complete``
    on both packages."""
    dirs = _dirs(tmp_path)
    states = {}
    for name, fluid in (("jax", jfluid), ("port", pfluid)):
        hb = PACKAGES[name]
        hb.WorkerHeartbeat(dirs[name], 0, interval=0.2).start()
        fluid.Executor(fluid.CPUPlace()).close()
        mon = hb.HeartBeatMonitor(dirs[name], n_workers=1, timeout=5.0)
        states[name] = mon.worker_status()
        assert hb._current is None
    assert states["port"] == states["jax"] == {0: jhb.COMPLETED}
    # with no heartbeat running, close() is a plain close
    pfluid.Executor(pfluid.CPUPlace()).close()


def test_a_restarted_worker_clears_its_done_mark(tmp_path):
    d = str(tmp_path)
    phb.WorkerHeartbeat(d, 0, interval=0.2).start().complete()
    assert os.path.exists(os.path.join(d, "done-0"))
    w = phb.WorkerHeartbeat(d, 0, interval=0.2).start()
    assert not os.path.exists(os.path.join(d, "done-0"))
    assert phb.HeartBeatMonitor(d, 1).worker_status() == {0: phb.RUNNING}
    w.complete()


def test_agree_dir_waits_for_item_6(tmp_path):
    with pytest.raises(NotImplementedError, match="item 6"):
        phb.WorkerHeartbeat(str(tmp_path), 0, agree_dir=str(tmp_path))
