"""The port's serving drills (``tools/chaos_drill.py --fleet``, ``--online``
and ``--oom``, in ``tools/serving_drill.py``) end to end on the CPU, with
the reference's PASS lines (``tests/test_chaos_drill.py``), and the fleet
leg of ``tools/serve_bench.py``: the four are started side by side once
for the module, each a fresh interpreter with ``--device cpu``.  Every
latency gate in the drills is a bound derived in the run (the drills'
docstring says how), never a fixed budget; the bench's QPS ratio is
printed, not gated."""

import os
import subprocess
import sys

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 600


def _start(*flags, tool="chaos_drill"):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    env.pop("PADDLE_TPU_CHAOS", None)
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.tools." + tool,
         "--check", "--device", "cpu"] + list(flags),
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


@pytest.fixture(scope="module")
def drills():
    procs = {"fleet": _start("--fleet", "--smoke"),
             "online": _start("--online", "--smoke"),
             "oom": _start("--oom"),
             # 12 clients: the scale-up signal needs a mean load above its
             # high_load of 3 over 3 replicas, and each closed-loop client
             # keeps one request out
             "bench": _start("--fleet", "--smoke", "--leg-secs", "2",
                             "--fleet-clients", "12", tool="serve_bench")}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()


def _finish(proc):
    out = proc.communicate(timeout=TIMEOUT_S)[0]
    assert proc.returncode == 0, out[-6000:]
    return out


def test_chaos_drill_fleet_smoke_gate(drills):
    out = _finish(drills["fleet"])
    for line in ("chaos_drill[fl]: PASS", "zero drops OK",
                 "kill-window bound OK", "alert precision OK",
                 "incident ledger OK", "autoscale citation OK",
                 "merged trace OK"):
        assert line in out, out[-6000:]


def test_chaos_drill_online_smoke_gate(drills):
    out = _finish(drills["online"])
    for line in ("chaos_drill[ol]: PASS", "zero-drop flips OK",
                 "quarantine veto OK", "flip bounds OK", "torn publish OK",
                 "rollback OK", "streaming resume bit-parity OK",
                 "trace_summary gate OK", "TraceMesh chain OK"):
        assert line in out, out[-6000:]


def test_chaos_drill_oom_gate(drills):
    out = _finish(drills["oom"])
    assert "chaos_drill --oom: PASS" in out
    assert "postmortem names ballast" in out


def test_serve_bench_fleet_smoke_gate(drills):
    """1 then 3 replicas behind the router over a read-only ShardPS owner:
    no drop, every replica's own captures, the rolling swap, the owner's
    table unwritten, autoscale both ways, sampled results in bound."""
    out = _finish(drills["bench"])
    for line in ("serve_bench[fleet]: PASS", '"metric": "fleet_1"',
                 '"metric": "fleet_3"', "rolling swap -> versions",
                 "retire replica"):
        assert line in out, out[-6000:]


@pytest.mark.slow
def test_chaos_drill_fleet_gate():
    out = _finish(_start("--fleet"))
    for line in ("chaos_drill[fl]: PASS", "generation adoption OK",
                 "alert precision OK", "canary detection OK"):
        assert line in out, out[-6000:]


@pytest.mark.slow
def test_chaos_drill_online_gate():
    out = _finish(_start("--online"))
    assert "chaos_drill[ol]: PASS" in out
