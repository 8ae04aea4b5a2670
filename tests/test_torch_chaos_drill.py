"""The port's fault-injection drill (``paddle_tpu_torch/tools/
chaos_drill.py``) as tier-1 gates on the CPU, as the JAX package's
``tests/test_chaos_drill.py`` runs its drill: ``--smoke --check`` (one
drill SIGTERM, a free restart under the port's launcher, resume, params
bit for bit a never-stopped run's, no retry giveups) and ``--elastic
--smoke --check`` (an n=2 fleet shrunk to 1 and grown back to 2 through
the topology-portable checkpoint, params bit for bit a never-stopped n=2
fleet's) and ``--hostps --smoke --check`` (a trainer and a ShardPS shard
owner: wire drops, duplicates and delays, the owner SIGKILLed and
respawned alone, the staleness window replayed, a live 2 -> 1 absorb; the
head and the whole table bit for bit a single-host HostPS run's).  The
three drills run side by side, started once for the module.  The
full-shape drills (``--check``, ``--elastic --check``, ``--hostps
--check``) and the ``--multiproc --check`` fleet drill are marked slow, as
the reference's are.
"""

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


def _start(*flags):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    env.pop("PADDLE_TPU_CHAOS", None)
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.tools.chaos_drill",
         "--check", "--device", "cpu"] + list(flags),
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


@pytest.fixture(scope="module")
def drills():
    procs = {"smoke": _start("--smoke"),
             "elastic": _start("--elastic", "--smoke"),
             "hostps": _start("--hostps", "--smoke")}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()


def _finish(proc):
    out = proc.communicate(timeout=TIMEOUT_S)[0]
    assert proc.returncode == 0, out[-6000:]
    return out


def test_chaos_drill_smoke_gate(drills):
    out = _finish(drills["smoke"])
    assert "chaos_drill: PASS" in out


def test_chaos_drill_elastic_smoke_gate(drills):
    out = _finish(drills["elastic"])
    assert "chaos_drill[el]: PASS" in out


def test_chaos_drill_hostps_smoke_gate(drills):
    out = _finish(drills["hostps"])
    for line in ("solo respawn OK", "bit-parity OK", "ps_wait CI gate OK",
                 "chaos_drill[ps]: PASS"):
        assert line in out, out[-6000:]


@pytest.mark.slow
def test_chaos_drill_hostps_gate():
    out = _finish(_start("--hostps"))
    assert "chaos_drill[ps]: PASS" in out


@pytest.mark.slow
def test_chaos_drill_multiproc_gate():
    out = _finish(_start("--multiproc"))
    assert "chaos_drill[mp]: PASS" in out


def test_unported_drills_name_their_items(capsys):
    from paddle_tpu_torch.tools import chaos_drill

    for mode, item in (("warmstart", "item 8"), ("overload", "item 10-C")):
        assert chaos_drill.main(["--" + mode, "--smoke", "--check",
                                 "--device", "cpu"]) == 2
        assert item in capsys.readouterr().out


@pytest.mark.slow
def test_chaos_drill_full_gate():
    out = _finish(_start())
    assert "chaos_drill: PASS" in out


@pytest.mark.slow
def test_chaos_drill_elastic_gate():
    out = _finish(_start("--elastic"))
    assert "chaos_drill[el]: PASS" in out
