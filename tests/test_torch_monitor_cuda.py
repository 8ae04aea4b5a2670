"""The port's monitor stack on the card: the sampled step's device time from
CUDA events, the allocator's watermarks in the memory snapshot, a plan's
ledger with its temp bytes, and refuse mode against the card's
``mem_get_info``.  Every test needs a card and skips without one; this file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_monitor_cuda.py
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import monitor
from paddle_tpu_torch.monitor import memscope


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monitor.disable()
    memscope.reset()
    yield torch.device("cuda")
    monitor.disable()
    memscope.reset()


def _mlp():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[64], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.fc(
            fluid.layers.fc(x, 256, act="relu"), 8))
        fluid.optimizer.Adam(1e-3).minimize(loss)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    return main, exe, scope, loss


def _feed(i):
    return {"x": np.random.RandomState(i).randn(32, 64).astype(np.float32)}


def test_sampled_steps_carry_cuda_event_times(cuda_device, tmp_path):
    main, exe, scope, loss = _mlp()
    mon = monitor.enable(str(tmp_path), device_time_every=2)
    for i in range(6):
        exe.run(main, feed=_feed(i), fetch_list=[loss], scope=scope)
    mon.timeline.flush()
    steps = monitor.read_events(str(tmp_path / "timeline.jsonl"), ev="step")
    timed = [e for e in steps if "device_ms" in e]
    assert len(steps) == 6 and len(timed) == 3
    assert all(e["device_ms"] > 0 for e in timed)


def test_snapshot_ledger_and_refusal_on_the_card(cuda_device, tmp_path):
    main, exe, scope, loss = _mlp()
    mon = monitor.enable(str(tmp_path))
    exe.run(main, feed=_feed(0), fetch_list=[loss], scope=scope)
    (_, ledger), = memscope.ledgers()
    assert ledger["temp_bytes"] >= 0 and ledger["argument_bytes"] > 0
    snap = mon.maybe_sample_memory(force=True)
    dev = snap["devices"]["cuda:0"]
    assert 0 < dev["bytes_in_use"] <= dev["peak_bytes_in_use"] <= dev["bytes_limit"]
    assert snap["owners"]["scope"] > 0 and 0 < snap["hbm_frac"]["cuda:0"] < 1
    memscope.configure(bytes_limit=1 << 20, refuse=True)
    with pytest.raises(memscope.MemoryBudgetError):
        exe.run(main, feed=_feed(1), fetch_list=[loss], scope=scope)


def test_an_out_of_memory_error_is_recognised(cuda_device):
    assert memscope.is_resource_exhausted(torch.cuda.OutOfMemoryError("x"))


_FRESH = r"""
import sys, tempfile
import paddle_tpu_torch as fluid
from paddle_tpu_torch import monitor
monitor.enable(tempfile.mkdtemp())
main, startup = fluid.Program(), fluid.Program()
with fluid.unique_name.guard(), fluid.program_guard(main, startup):
    x = fluid.layers.data("x", shape=[4], dtype="float32")
    fluid.layers.fc(x, 2)
exe = fluid.Executor(fluid.CUDAPlace(0))
exe.run(startup, scope=fluid.Scope())    # the process's first CUDA work
monitor.disable()
print("FRESH OK")
"""


def test_ledger_probe_in_a_fresh_process(cuda_device):
    """A monitored startup program that is a fresh process's first work on
    the card: the plan's ledger probe initialises CUDA before it reads the
    allocator's statistics."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _FRESH], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=root))
    assert r.returncode == 0 and "FRESH OK" in r.stdout, r.stderr[-3000:]
