"""The port's ``DeviceFeedPipe``, ``InFlightWindow`` and DataLoader
prefetch on the CPU, mirroring the JAX package's ``tests/test_feed_pipe.py``
and ``tests/test_dataloader_prefetch.py``: order kept under a slow
producer, ``drop_last`` through the DataLoader, a worker's exception with
its traceback, a capacity of 1 warned and clamped, the one-ahead
announcements, the in-flight window's bound and drain, shutdown in the
middle of an iteration, lazy fetches with no inline sync, and the monitor's
``monitor.pipe.*`` stats from a ``train_from_dataset`` run.  Each loader
case also runs through the JAX package's DataLoader on the same batches,
which must come out equal.

On the CPU the staging step is ``torch.from_numpy``; the pinned-buffer
copy on a side stream and its event run on the card (``chip_smoke.py``'s
``dataloader``, ``ctr_dataset`` and ``deepfm_hostfed`` phases).
"""

import threading
import time
import traceback
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu.reader import DataLoader as JaxLoader
from paddle_tpu_torch import monitor
from paddle_tpu_torch import reader as reader_mod
from paddle_tpu_torch.feed_pipe import (DeviceFeedPipe, InFlightWindow,
                                        make_feed_convert, make_placer)
from paddle_tpu_torch.reader import DataLoader
from paddle_tpu_torch.tools import ctr_program as cp


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = pfluid.CPUPlace()


def test_pipe_order_preserved_under_slow_producer():
    def slow_source():
        for i in range(30):
            if i % 7 == 0:
                time.sleep(0.005)          # jittery producer
            yield i

    pipe = DeviceFeedPipe(slow_source(), convert=lambda x: x * 10, depth=3)
    assert list(pipe) == [i * 10 for i in range(30)]


def _sample_loader(fluid, loader_cls, drop_last, **kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("px", shape=[2], dtype="float32")
    loader = loader_cls.from_generator(feed_list=[x], capacity=4)

    def samples():
        for i in range(10):
            yield (np.full((2,), i, "float32"),)

    loader.set_sample_generator(samples, batch_size=4, drop_last=drop_last,
                                **kw)
    return loader


@pytest.mark.parametrize("drop_last,sizes", [(False, [4, 4, 2]),
                                             (True, [4, 4])])
def test_pipe_drop_last_through_dataloader(drop_last, sizes):
    got = list(_sample_loader(pfluid, DataLoader, drop_last, places=CPU))
    want = list(_sample_loader(jfluid, JaxLoader, drop_last))
    assert [b["px"].shape[0] for b in got] == sizes
    for g, w in zip(got, want):
        assert isinstance(g["px"], torch.Tensor)
        np.testing.assert_array_equal(g["px"].numpy(), np.asarray(w["px"]))


def test_pipe_exception_carries_worker_traceback():
    def exploding():
        yield 1
        yield 2
        raise ValueError("kaboom at item 3")

    pipe = DeviceFeedPipe(exploding(), depth=2)
    got = []
    with pytest.raises(ValueError, match="kaboom") as ei:
        for item in pipe:
            got.append(item)
    assert got == [1, 2]                    # items before the crash delivered
    frames = "".join(traceback.format_exception(ei.type, ei.value, ei.tb))
    assert "exploding" in frames


def _batch_loader(capacity, n=3, use_double_buffer=True):
    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.program_guard(main, startup):
        x = pfluid.layers.data("pw", shape=[2], dtype="float32")
        i = pfluid.layers.data("pi", shape=[1], dtype="int64")
    loader = DataLoader.from_generator(feed_list=[x, i], capacity=capacity,
                                       use_double_buffer=use_double_buffer)

    def gen():
        for k in range(n):
            yield {"pw": np.full((2, 2), k, "f8"), "pi": np.full((2, 1), k)}

    loader.set_batch_generator(gen, places=CPU)
    return loader


def test_pipe_capacity_one_warns_and_clamps():
    loader = _batch_loader(capacity=1)
    reader_mod._CAPACITY_WARNED.clear()
    with pytest.warns(UserWarning, match="clamping"):
        got = list(loader)
    # clamped, not degraded to inline: batches still staged, in the
    # declared dtypes
    assert len(got) == 3
    assert all(isinstance(b["pw"], torch.Tensor)
               and b["pw"].dtype == torch.float32
               and b["pi"].dtype == torch.int64 for b in got)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert len(list(loader)) == 3


def test_loader_without_double_buffer_yields_the_host_batches():
    got = list(_batch_loader(capacity=4, use_double_buffer=False))
    assert all(isinstance(b["pw"], np.ndarray) for b in got)


def test_pipe_one_ahead_announcements_complete():
    announced, taken = [], []

    def src():
        for i in range(8):
            time.sleep(0.004)            # consumer outruns producer
            yield i

    pipe = DeviceFeedPipe(src(), notify=announced.append, depth=3)
    for item in pipe:
        assert all(a <= item + 1 for a in announced)
        taken.append(item)
        time.sleep(0.001)
    assert taken == list(range(8))
    assert announced == list(range(1, 8))


def test_inflight_window_bounds_and_drains():
    w = InFlightWindow(k=2)
    for i in range(6):
        w.admit([torch.zeros(()) + i])
        assert len(w) <= 2
    w.drain()
    assert len(w) == 0


def test_prefetch_shutdown_mid_iteration():
    n_before = threading.active_count()
    loader = _batch_loader(capacity=2, n=1000)
    it = iter(loader)
    next(it)
    next(it)
    it.close()
    deadline = time.time() + 10
    while threading.active_count() > n_before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= n_before + 1


def test_prefetch_order_preserved():
    loader = _batch_loader(capacity=4, n=20)
    assert [int(b["pi"][0, 0]) for b in loader] == list(range(20))


def test_feed_convert_coerces_to_the_declared_dtypes():
    convert = make_feed_convert({"a": np.dtype("float32"),
                                 "b": np.dtype("int64")}.get,
                                make_placer("cpu"))
    out = convert({"a": [[1, 2]], "b": np.array([[3]], np.int32),
                   "c": torch.ones(1, dtype=torch.float64)})
    assert out["a"].dtype == torch.float32 and out["b"].dtype == torch.int64
    assert out["c"].dtype == torch.float64      # undeclared: as it came


def _tiny_train_program():
    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.program_guard(main, startup):
        x = pfluid.layers.data("x", shape=[4], dtype="float32")
        y = pfluid.layers.data("y", shape=[1], dtype="float32")
        pred = pfluid.layers.fc(x, 1)
        loss = pfluid.layers.mean(pfluid.layers.square_error_cost(pred, y))
        pfluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def test_lazy_fetch_no_inline_sync(tmp_path):
    """return_numpy=False returns tensors and never bumps the inline
    fetch-sync counter; the eager default does; a lazily fetched
    parameter stays readable after later steps."""
    main, startup, loss = _tiny_train_program()
    exe = pfluid.Executor(CPU)
    mon = monitor.enable(str(tmp_path / "mon"), device_time_every=10 ** 9)

    def _inline():
        s = mon.registry.get_stat("monitor.fetch.inline_sync")
        return 0 if s is None else s.value

    base = _inline()
    try:
        exe.run(startup)
        rng = np.random.RandomState(0)
        feed = {"x": rng.rand(8, 4).astype("f4"),
                "y": rng.rand(8, 1).astype("f4")}
        w = main.global_block().all_parameters()[0].name
        res = [exe.run(main, feed=feed, fetch_list=[loss, w],
                       return_numpy=False) for _ in range(5)]
        assert _inline() == base
        assert len(exe.inflight) <= exe.inflight.k
        exe.drain()
        assert len(exe.inflight) == 0
        vals = [float(r[0]) for r in res]
        assert vals[-1] < vals[0]
        assert not torch.equal(res[0][1], res[-1][1])
        exe.run(main, feed=feed, fetch_list=[loss])
        assert _inline() == base + 1
    finally:
        monitor.disable()


def test_train_from_dataset_pipe_reports_its_stats(tmp_path):
    files = cp.write_ctr_files(str(tmp_path / "data"), n_files=2,
                               rows_per_file=64)
    prog = cp.build_ctr_program(pfluid)
    exe = pfluid.Executor(CPU)
    scope = pfluid.Scope()
    exe.run(prog.startup, scope=scope)
    ds = cp.make_dataset(pfluid, "QueueDataset", files, prog, 16)
    mon = monitor.enable(str(tmp_path / "mon"))
    try:
        exe.train_from_dataset(prog.main, ds, scope=scope,
                               fetch_list=[prog.loss])
        reg = mon.registry
        assert reg.get_stat("monitor.pipe.batches").value == 8
        for name in ("feed_stall_ms", "overlap_ms", "convert_ms"):
            assert reg.get_stat("monitor.pipe." + name).calls == 8
    finally:
        monitor.disable()
    events = [e.get("ev") for e in monitor.read_events(
        str(tmp_path / "mon" / "timeline.jsonl"))]
    assert events.count("pipe") == 8
    assert "run_start" in events and "run_end" in events


def test_train_through_prefetched_loader():
    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.program_guard(main, startup):
        x = pfluid.layers.data("x", shape=[8], dtype="float32")
        y = pfluid.layers.data("y", shape=[1], dtype="float32")
        pred = pfluid.layers.fc(x, 1)
        loss = pfluid.layers.mean(pfluid.layers.square_error_cost(pred, y))
        pfluid.optimizer.SGD(0.05).minimize(loss)
        loader = DataLoader.from_generator(feed_list=[x, y], capacity=4)
    rng = np.random.RandomState(0)
    W = rng.randn(8, 1).astype("f4")

    def gen():
        for _ in range(40):
            xs = rng.randn(32, 8).astype("f4")
            yield {"x": xs, "y": xs @ W}

    loader.set_batch_generator(gen, places=CPU)
    exe = pfluid.Executor(CPU)
    exe.run(startup)
    losses = [float(exe.run(main, feed=b, fetch_list=[loss.name])[0])
              for b in loader]
    assert losses[-1] < losses[0] * 0.5 and np.isfinite(losses[-1])
