"""The port's dataset path against the JAX package's on the CPU.

The same seeded MultiSlot files (every 7th line malformed where noted) go
through both packages' ``QueueDataset`` and ``InMemoryDataset``, with the
native parser (each package's own build of ``runtime/datafeed.cc``) and
with the pure-Python one (``PADDLE_TPU_NO_NATIVE=1``): the batches are
equal, element for element and in order; ``local_shuffle`` draws the same
``np.random.RandomState(seed)`` sequence, so both shuffle rows into the
same order; ``pipe_command`` gives the same rows.

The CTR program of the JAX package's ``tests/test_dataset.py``
(``tools/ctr_program.py``; n_fields 8, vocab 200, two ``is_sparse`` tables
under Adam) trains two passes through ``Executor.train_from_dataset`` in
both packages from the JAX startup's values: every step's loss and every
persistable after the passes, the sparse tables' Adam moments and
beta-pow accumulators included, to 1e-5 of the largest magnitude (f32;
the two frameworks sum in other orders).
"""

import os
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu_torch import convert, runtime
from paddle_tpu_torch.tools import ctr_program as cp

RUN_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def files(tmp_path):
    return cp.write_ctr_files(str(tmp_path), n_files=3, rows_per_file=70,
                              malformed_every=7)


def _dataset(fluid, kind, files, batch=16, thread=1):
    with fluid.unique_name.guard(), fluid.program_guard(fluid.Program(),
                                                        fluid.Program()):
        ids = fluid.layers.data("feat_ids", shape=[8], dtype="int64")
        label = fluid.layers.data("label", shape=[1], dtype="float32")
    ds = fluid.DatasetFactory().create_dataset(kind)
    ds.set_batch_size(batch)
    ds.set_thread(thread)
    ds.set_filelist(files)
    ds.set_use_var([ids, label])
    if kind == "InMemoryDataset":
        ds.load_into_memory()
    return ds


def _batches(ds, **kw):
    return [(b["feat_ids"].copy(), b["label"].copy())
            for b in ds._iter_batches(**kw)]


def _same_batches(got, want):
    assert len(got) == len(want)
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == np.int64 and gl.dtype == np.float32
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_native_datafeed_is_the_ports_own_build():
    lib = runtime.load("datafeed")
    assert lib is not None
    info = runtime.build_info["datafeed"]
    path = os.path.realpath(info["path"])
    assert path == os.path.realpath(str(runtime.library_path("datafeed")))
    assert os.path.realpath(str(runtime.BUILD_DIR)) in path
    assert "paddle_tpu/runtime" not in path


def test_no_native_selects_the_python_parser(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_NO_NATIVE", "1")
    assert runtime.load("datafeed") is None


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("kind", ["QueueDataset", "InMemoryDataset"])
def test_batches_match_jax(files, kind, native, monkeypatch):
    """Both packages parse the same files into the same batches, malformed
    lines dropped (70 lines a file, 10 of them malformed)."""
    if not native:
        monkeypatch.setenv("PADDLE_TPU_NO_NATIVE", "1")
    got = _batches(_dataset(pfluid, kind, files))
    want = _batches(_dataset(jfluid, kind, files))
    _same_batches(got, want)
    assert sum(len(i) for i, _ in got) == 3 * 60


def test_native_and_python_parsers_agree(files, monkeypatch):
    native = _batches(_dataset(pfluid, "QueueDataset", files))
    monkeypatch.setenv("PADDLE_TPU_NO_NATIVE", "1")
    _same_batches(_batches(_dataset(pfluid, "QueueDataset", files)), native)


def test_queue_four_threads_same_multiset(files):
    got = _batches(_dataset(pfluid, "QueueDataset", files, thread=4))
    want = _batches(_dataset(jfluid, "QueueDataset", files, thread=1))
    rows = lambda bs: np.concatenate(
        [np.concatenate([i, l.astype(np.int64)], 1) for i, l in bs])
    g, w = rows(got), rows(want)
    np.testing.assert_array_equal(g[np.lexsort(g.T)], w[np.lexsort(w.T)])


def test_local_shuffle_same_order_as_jax(files):
    p = _dataset(pfluid, "InMemoryDataset", files)
    j = _dataset(jfluid, "InMemoryDataset", files)
    before = _batches(p)
    for _ in range(2):
        p.local_shuffle()
        j.local_shuffle()
        _same_batches(_batches(p), _batches(j))
    assert not np.array_equal(_batches(p)[0][0], before[0][0])


def test_global_shuffle_at_world_one_matches_jax(files):
    p = _dataset(pfluid, "InMemoryDataset", files)
    j = _dataset(jfluid, "InMemoryDataset", files)
    p.global_shuffle()
    j.global_shuffle()
    _same_batches(_batches(p), _batches(j))
    assert p.get_memory_data_size() == j.get_memory_data_size() == 180


def test_cursor_iteration_matches_jax(files):
    p = _dataset(pfluid, "QueueDataset", files, batch=16)
    j = _dataset(jfluid, "QueueDataset", files, batch=16)
    pc = list(p._iter_batches(with_cursor=True, skip_to=(0, 1)))
    jc = list(j._iter_batches(with_cursor=True, skip_to=(0, 1)))
    assert [c for c, _ in pc] == [c for c, _ in jc]
    for (_, a), (_, b) in zip(pc, jc):
        np.testing.assert_array_equal(a["feat_ids"], b["feat_ids"])


def test_pipe_command_same_as_jax(tmp_path):
    src = tmp_path / "raw.txt"
    src.write_text("a,1 5,1 0.5\nb,1 9,1 1.5\nc,1 7\n")
    cmd = "cut -d, -f2,3 --output-delimiter=' '"
    out = {}
    for name, fluid in (("port", pfluid), ("jax", jfluid)):
        with fluid.unique_name.guard(), fluid.program_guard(
                fluid.Program(), fluid.Program()):
            ids = fluid.layers.data("feat_ids", shape=[1], dtype="int64")
            label = fluid.layers.data("label", shape=[1], dtype="float32")
        ds = fluid.DatasetFactory().create_dataset("QueueDataset")
        ds.set_batch_size(4)
        ds.set_filelist([str(src)])
        ds.set_use_var([ids, label])
        ds.set_pipe_command(cmd)
        out[name] = _batches(ds)
    _same_batches(out["port"], out["jax"])
    np.testing.assert_array_equal(out["port"][0][0][:, 0], [5, 9])


def test_queue_dataset_shuffle_raises():
    ds = pfluid.DatasetFactory().create_dataset("QueueDataset")
    with pytest.raises(NotImplementedError):
        ds.local_shuffle()
    with pytest.raises(NotImplementedError):
        ds.global_shuffle()
    with pytest.raises(ValueError, match="does not exist"):
        pfluid.DatasetFactory().create_dataset("NoSuchDataset")


# -- train_from_dataset against the JAX executor ----------------------------------

def _record_losses(exe, out, to_float):
    run = exe.run

    def wrapped(*args, **kwargs):
        res = run(*args, **kwargs)
        if res:
            out.append(to_float(res[0]))
        return res

    exe.run = wrapped


def _ctr_pair(tmp_path, kind, thread=1):
    files = cp.write_ctr_files(str(tmp_path), n_files=3, rows_per_file=128)
    jp, pp = cp.build_ctr_program(jfluid), cp.build_ctr_program(pfluid)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jp.startup, scope=jscope)
    names = cp.persistable_names(jp.main)
    assert names == cp.persistable_names(pp.main)
    values = {n: jscope.find_tensor_as_numpy(n) for n in names}
    pscope = convert.scope_from_numpy(values, pfluid.Scope(), "cpu")
    pexe = pfluid.Executor(pfluid.CPUPlace())
    jds = cp.make_dataset(jfluid, kind, files, jp, 32, thread)
    pds = cp.make_dataset(pfluid, kind, files, pp, 32, thread)
    if kind == "InMemoryDataset":
        jds.load_into_memory()
        pds.load_into_memory()
    return (jexe, jscope, jp, jds), (pexe, pscope, pp, pds), names


@pytest.mark.parametrize("kind,pipe", [("InMemoryDataset", "on"),
                                       ("QueueDataset", "on"),
                                       ("InMemoryDataset", "off")])
def test_ctr_program_trains_like_jax(tmp_path, kind, pipe, monkeypatch):
    if pipe == "off":
        monkeypatch.setenv("PADDLE_TPU_FEED_PIPE", "0")
    (jexe, jscope, jp, jds), (pexe, pscope, pp, pds), names = _ctr_pair(
        tmp_path, kind)
    jl, pl = [], []
    _record_losses(jexe, jl, lambda r: float(np.asarray(r)))
    _record_losses(pexe, pl, lambda r: float(r.detach().cpu().numpy()))
    for _ in range(2):
        if kind == "InMemoryDataset":
            jds.local_shuffle()
            pds.local_shuffle()
        jexe.train_from_dataset(jp.main, jds, scope=jscope,
                                fetch_list=[jp.loss])
        pexe.train_from_dataset(pp.main, pds, scope=pscope,
                                fetch_list=[pp.loss])
    assert len(pl) == len(jl) == 24
    np.testing.assert_allclose(pl, jl, rtol=RUN_TOL, atol=0)
    for n in names:
        got = pscope.find_tensor_as_numpy(n).astype(np.float64)
        want = np.asarray(jscope.find_tensor_as_numpy(n), np.float64)
        assert got.shape == want.shape, n
        err = np.abs(got - want).max()
        assert err <= RUN_TOL * max(np.abs(want).max(), 1e-30), (n, err)
    assert np.mean(pl[12:]) < np.mean(pl[:12])


def test_infer_from_dataset_leaves_the_state(tmp_path):
    _, (pexe, pscope, pp, pds), names = _ctr_pair(tmp_path, "QueueDataset")
    infer = pp.main.clone(for_test=True)
    before = {n: pscope.find_tensor_as_numpy(n).copy() for n in names}
    pexe.infer_from_dataset(infer, pds, scope=pscope, fetch_list=[pp.loss])
    for n in names:
        np.testing.assert_array_equal(pscope.find_tensor_as_numpy(n),
                                      before[n])


def test_fetch_handler_and_async_executor(tmp_path):
    _, (pexe, pscope, pp, pds), _ = _ctr_pair(tmp_path, "QueueDataset")
    seen = []

    class Handler(pfluid.FetchHandler):
        def handler(self, fetch_dict):
            seen.append(fetch_dict)

    pexe.train_from_dataset(pp.main, pds, scope=pscope,
                            fetch_handler=Handler({"w": pp.tables[0]},
                                                  period_secs=60))
    assert len(seen) == 1 and seen[0]["w"].shape == (200, 8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        aexe = pfluid.AsyncExecutor(pfluid.CPUPlace())
    with pfluid.scope_guard(pscope):
        aexe.run(pp.main, pds, pds.filelist, 1, [pp.loss])


@pytest.mark.parametrize("pipe", ["on", "off"])
def test_infer_rejects_checkpoint_and_prefetch_waits_for_item_7(
        tmp_path, pipe, monkeypatch):
    """``infer_from_dataset`` refuses ``checkpoint=``; the one-batch
    lookahead announces batch k+1 to the HostPS prefetch hooks before batch
    k is consumed, as JAX's ``_iter_with_prefetch`` does, and
    ``train_from_dataset`` announces each next batch's ids (through the feed
    pipe, or the inline lookahead with the pipe off) to an attached
    ``HostPSEmbedding``, whose prefetches stay pending: this program pulls
    nothing through it."""
    from paddle_tpu import trainer as jtrainer
    from paddle_tpu.hostps import service as jservice
    from paddle_tpu_torch import trainer
    from paddle_tpu_torch.hostps import (HostPSEmbedding, HostSparseTable,
                                         service)

    if pipe == "off":
        monkeypatch.setenv("PADDLE_TPU_FEED_PIPE", "0")
    _, (pexe, pscope, pp, pds), _ = _ctr_pair(tmp_path, "QueueDataset")
    with pytest.raises(ValueError, match="training only"):
        pexe.infer_from_dataset(pp.main, pds, scope=pscope,
                                checkpoint=object())
    feeds = [{"ids": np.array([i])} for i in range(4)]
    orders = []
    for mod, svc in ((trainer, service), (jtrainer, jservice)):
        seen = []
        hook = svc.register_prefetch_hook(
            lambda feed, seen=seen: seen.append(int(feed["ids"][0])))
        try:
            orders.append([(int(f["ids"][0]), list(seen))
                           for f in mod._iter_with_prefetch(iter(feeds))])
        finally:
            svc.unregister_prefetch_hook(hook)
        assert seen == [1, 2, 3]
    assert orders[0] == orders[1]
    for cur, announced in orders[0]:
        assert announced == list(range(1, min(cur + 2, 4)))
    assert next(trainer._iter_with_prefetch(iter([{}]))) == {}

    emb = HostPSEmbedding(HostSparseTable(200, 4, seed=0), device="cpu")
    emb.attach_prefetch_slot("feat_ids")
    try:
        pexe.train_from_dataset(pp.main, pds, scope=pscope)
    finally:
        emb.detach_prefetch_hooks()
    assert not service.has_prefetch_hooks()
    assert emb._pending and emb.table.rows_initialized > 0
    service._LIVE_EMBEDDINGS.discard(emb)
