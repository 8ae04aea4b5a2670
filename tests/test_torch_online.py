"""The port's online loop (``paddle_tpu_torch/online``: stream, delta
publish, VersionSwapper) against the JAX package's on the CPU.

The reference's cases (``tests/test_online.py``: the streaming source, the
publish chain and the swapper) run on the port.  A chain published by the
JAX package resolves and applies in the port, and one published by the port
in the JAX package, dense and rows bit for bit (the chain's files are one
byte layout).  The whole loop at small widths — train, publish, flip under
load, roll back — runs in both packages from the same seeds; the outputs
agree within the reference's serving tolerance (rtol 1e-5, atol 1e-6, f32),
the rows and counters exactly.

One deliberate difference: after a flip the port's serving table holds
exactly the target chain's rows (rows an earlier flip installed that the
target does not hold go back to the initializer), so a rollback serves the
target version; the reference keeps such rows at the later version's
values (``test_rollback_forgets_rows_the_target_never_held``).
"""

import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.online  # noqa: F401
import paddle_tpu.serving  # noqa: F401
import paddle_tpu_torch as pfluid
from paddle_tpu_torch import online
from paddle_tpu_torch.dataset import DatasetFactory
from paddle_tpu_torch.hostps import HostPSEmbedding, HostSparseTable
from paddle_tpu_torch.hostps.optimizer import HostAdagrad
from paddle_tpu_torch.inference import load_exported_model
from paddle_tpu_torch.online import (DeltaPublisher, StreamingSource,
                                     VersionSwapper, committed_publishes,
                                     latest_version, load_chain_rows,
                                     resolve_chain)
from paddle_tpu_torch.parallel.checkpoint import save_checkpoint
from paddle_tpu_torch.serving import BucketLattice, CTRLookup, ServeEngine
from paddle_tpu_torch.tools import serve_bench

RTOL, ATOL = 1e-5, 1e-6
FEED_SPEC = serve_bench.SMOKE_FEED_SPEC


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------- streaming source --

def _write_ctr_file(path, rows, n_fields=4, vocab=60, seed=0):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(rows):
            ids = rng.randint(0, vocab, n_fields)
            f.write("%d %s 1 %.1f\n"
                    % (n_fields, " ".join(map(str, ids)),
                       float(ids.sum() % 2)))
    return str(path)


def _make_dataset(files, batch=8, n_fields=4, fluid=pfluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data("feat_ids", shape=[n_fields], dtype="int64")
        label = fluid.layers.data("label", shape=[1], dtype="float32")
    factory = DatasetFactory if fluid is pfluid else fluid.DatasetFactory
    ds = factory().create_dataset("QueueDataset")
    ds.set_batch_size(batch)
    ds.set_thread(1)
    ds.set_filelist(list(files))
    ds.set_use_var([ids, label])
    return ds


def _rows_of(batches):
    return np.concatenate([b["feat_ids"] for b in batches])


def test_streaming_source_is_dataset_shaped_and_bounded(tmp_path):
    files = [_write_ctr_file(tmp_path / "a", 20, seed=1)]
    ds = _make_dataset(files)
    src = StreamingSource(ds)
    assert src.proto_desc is ds.proto_desc
    assert src.queue_num is ds.queue_num
    batches = list(src._iter_batches())
    want = list(_make_dataset(files)._iter_batches(num_threads=1))
    np.testing.assert_array_equal(_rows_of(batches), _rows_of(want))
    wm = src.watermark
    assert wm["batches"] == len(batches) and wm["cursor"] is not None


def test_streaming_source_matches_the_jax_package(tmp_path):
    """The same files through both packages' sources: the same batches
    and cursors."""
    files = [_write_ctr_file(tmp_path / ("q%d" % i), 13, seed=20 + i)
             for i in range(2)]
    got = list(StreamingSource(_make_dataset(files))._iter_batches(
        with_cursor=True))
    want = list(jfluid.online.StreamingSource(
        _make_dataset(files, fluid=jfluid))._iter_batches(with_cursor=True))
    assert [tuple(c) for c, _f in got] == [tuple(c) for c, _f in want]
    for (_c, g), (_d, w) in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))


def test_streaming_source_consumes_files_appearing_mid_stream(tmp_path):
    f0 = _write_ctr_file(tmp_path / "part-0", 16, seed=2)
    visible = [f0]
    src = StreamingSource(_make_dataset(list(visible)),
                          file_provider=lambda: list(visible),
                          poll_secs=0.01, idle_secs=5.0)
    got = []
    added = threading.Event()

    def producer():
        while src.watermark["batches"] < 2:
            time.sleep(0.005)
        visible.append(_write_ctr_file(tmp_path / "part-1", 16, seed=3))
        added.set()

    t = threading.Thread(target=producer)
    t.start()
    for cur, feed in src._iter_batches(with_cursor=True):
        got.append((cur, feed))
        if len(got) == 4:
            src.stop()
    t.join()
    assert added.is_set() and len(got) == 4
    cursors = [c for c, _f in got]
    assert cursors == sorted(cursors) and cursors[-1][0] == 1
    want = list(_make_dataset([f0, str(tmp_path / "part-1")])._iter_batches(
        num_threads=1))
    np.testing.assert_array_equal(_rows_of([f for _c, f in got]),
                                  _rows_of(want))


def test_streaming_source_resumes_bit_exact_from_cursor(tmp_path):
    files = [_write_ctr_file(tmp_path / ("p%d" % i), 20, seed=10 + i)
             for i in range(3)]
    full = list(StreamingSource(_make_dataset(files))._iter_batches(
        with_cursor=True))
    cut = len(full) // 2
    tail = list(StreamingSource(_make_dataset(files))._iter_batches(
        skip_to=full[cut - 1][0], with_cursor=True))
    assert [c for c, _f in tail] == [c for c, _f in full[cut:]]
    np.testing.assert_array_equal(_rows_of([f for _c, f in tail]),
                                  _rows_of([f for _c, f in full[cut:]]))


def test_streaming_source_rejects_mutated_file_list(tmp_path):
    files = [_write_ctr_file(tmp_path / "x", 8, seed=4)]
    shuffled = [_write_ctr_file(tmp_path / "y", 8, seed=5)]
    src = StreamingSource(_make_dataset(files),
                          file_provider=lambda: list(shuffled))
    with pytest.raises(RuntimeError, match="append-only"):
        list(src._iter_batches())


def test_streaming_source_max_batches_and_idle_bound(tmp_path):
    files = [_write_ctr_file(tmp_path / "z", 64, seed=6)]
    src = StreamingSource(_make_dataset(files),
                          file_provider=lambda: list(files),
                          poll_secs=0.01, idle_secs=0.05, max_batches=3)
    assert len(list(src._iter_batches())) == 3
    src2 = StreamingSource(_make_dataset(files),
                           file_provider=lambda: list(files),
                           poll_secs=0.01, idle_secs=0.05)
    t0 = time.monotonic()
    assert len(list(src2._iter_batches())) == 8
    assert time.monotonic() - t0 < 10


# ------------------------------------------------------------ publish chain --

def _touch(table, rng, k=12):
    """One training interval: init some rows via pull, push grads."""
    ids = rng.randint(0, table.vocab_size, size=k).astype(np.int64)
    table.pull(ids)
    table.push(ids, rng.randn(k, table.dim).astype(np.float32), 0.1)
    return ids


def test_delta_chain_replays_bit_identical_to_full_snapshot(tmp_path):
    rng = np.random.RandomState(0)
    for trial in range(3):
        pub_dir = str(tmp_path / ("chain%d" % trial))
        table = HostSparseTable(96, 6, seed=7, name="ctr",
                                optimizer=HostAdagrad())
        pub = DeltaPublisher(pub_dir, hostps=[table])
        state = {"w": rng.randn(4, 3).astype(np.float32)}
        for step in range(1, 5):
            _touch(table, rng, k=int(rng.randint(1, 20)))
            state["w"] = state["w"] + 1.0
            assert pub.publish(state, step=step) == step
        pubs = committed_publishes(pub_dir)
        assert [m["kind"] for _v, _p, m in pubs] == \
            ["base", "delta", "delta", "delta"]
        chain = resolve_chain(pub_dir)
        rows, arrays = load_chain_rows(chain, "ctr")
        ref_rows, ref_arrays, _meta = table.snapshot()
        np.testing.assert_array_equal(rows, ref_rows)
        for key in ref_arrays:
            np.testing.assert_array_equal(arrays[key], ref_arrays[key])
        dense = online.load_chain_dense(
            chain, {"dense": {"w": np.zeros((4, 3), np.float32)}})
        np.testing.assert_array_equal(dense["dense"]["w"], state["w"])
        serve = HostSparseTable(96, 6, seed=7, name="ctr",
                                optimizer=HostAdagrad())
        serve.adopt_rows(rows, arrays)
        s_rows, s_arrays, _m = serve.snapshot()
        np.testing.assert_array_equal(s_rows, ref_rows)
        np.testing.assert_array_equal(s_arrays["param"], ref_arrays["param"])


def test_delta_publish_failure_remarks_rows_for_next_publish(tmp_path):
    from paddle_tpu_torch.ft import chaos

    rng = np.random.RandomState(1)
    table = HostSparseTable(64, 4, seed=3, name="ctr")
    pub = DeltaPublisher(str(tmp_path / "chain"), hostps=[table])
    pub.publish({"w": np.zeros(2, np.float32)}, step=1)
    ids = _touch(table, rng)
    assert table.touched_rows_pending > 0
    chaos.arm("ckpt_commit", at=1)
    try:
        with pytest.raises(chaos.ChaosError):
            pub.publish({"w": np.zeros(2, np.float32)}, step=2)
    finally:
        chaos.disarm()
    assert table.touched_rows_pending >= len(set(ids.tolist()))
    pub2 = DeltaPublisher(str(tmp_path / "chain"), hostps=[table])
    v = pub2.publish({"w": np.zeros(2, np.float32)}, step=2)
    assert v == 2 and table.touched_rows_pending == 0
    rows, _arrays = load_chain_rows(resolve_chain(str(tmp_path / "chain")),
                                    "ctr")
    assert set(ids.tolist()) <= set(rows.tolist())


def test_resharded_two_rank_publish_restores_on_one(tmp_path, monkeypatch):
    rng = np.random.RandomState(2)
    pub_dir = str(tmp_path / "chain")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TPU_CKPT_BARRIER_SECS", "30")
    t0 = HostSparseTable(80, 4, seed=9, name="ctr", row_range=(0, 40))
    t1 = HostSparseTable(80, 4, seed=9, name="ctr", row_range=(40, 80))
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    pub1 = DeltaPublisher(pub_dir, hostps=[t1])
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    pub0 = DeltaPublisher(pub_dir, hostps=[t0])
    for t, lo, hi in ((t0, 0, 40), (t1, 40, 80)):
        ids = rng.randint(lo, hi, size=10).astype(np.int64)
        t.pull(ids)
        t.push(ids, rng.randn(10, 4).astype(np.float32), 0.1)
    dense = {"w": np.arange(6, dtype=np.float32)}
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    pub1.publish(dense, step=3)
    assert latest_version(pub_dir) is None
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    assert pub0.publish(dense, step=3) == 1
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
    chain = resolve_chain(pub_dir)
    assert chain[-1][2]["saver_world"] == 2
    rows, arrays = load_chain_rows(chain, "ctr")
    full = HostSparseTable(80, 4, seed=9, name="ctr")
    full.adopt_rows(rows, arrays)
    for t in (t0, t1):
        r, a, _m = t.snapshot()
        got = full.pull(r.reshape(-1, 1)).reshape(r.size, -1)
        np.testing.assert_array_equal(got, a["param"])
    got_dense = online.load_chain_dense(
        chain, {"dense": {"w": np.zeros(6, np.float32)}})
    np.testing.assert_array_equal(got_dense["dense"]["w"], dense["w"])


def test_quarantined_step_never_enters_publish_chain(tmp_path):
    qdir = str(tmp_path / "quarantine")
    pub_dir = str(tmp_path / "chain")
    table = HostSparseTable(64, 4, seed=1, name="ctr")
    pub = DeltaPublisher(pub_dir, hostps=[table], quarantine_dir=qdir)
    state = {"w": np.zeros(3, np.float32)}
    assert pub.publish(state, step=3) == 1
    save_checkpoint(qdir, {"poisoned": np.ones(2)}, step=5,
                    asynchronous=False, tag="quarantine")
    assert pub.publish(state, step=6) is None
    assert latest_version(pub_dir) == 1
    assert pub.publish(state, step=9) == 2
    steps = [m["train_step"] for _v, _p, m in committed_publishes(pub_dir)]
    assert steps == [3, 9]


def test_publish_chain_prune_keeps_newest_bases(tmp_path):
    pub_dir = str(tmp_path / "chain")
    state = {"w": np.zeros(2, np.float32)}
    versions = []
    for i in range(3):
        pub = DeltaPublisher(pub_dir, keep_bases=2)
        versions.append(pub.publish(state, step=10 * i + 1))
        versions.append(pub.publish(state, step=10 * i + 2))
    pubs = committed_publishes(pub_dir)
    assert [m["kind"] for _v, _p, m in pubs] == \
        ["base", "delta", "base", "delta"]
    assert [v for v, _p, _m in pubs] == versions[2:]
    assert [v for v, _p, _m in resolve_chain(pub_dir)] == versions[4:]


def test_resolve_chain_rejects_gaps(tmp_path):
    pub_dir = str(tmp_path / "chain")
    pub = DeltaPublisher(pub_dir, keep_bases=5)
    state = {"w": np.zeros(2, np.float32)}
    for s in (1, 2, 3):
        pub.publish(state, step=s)
    shutil.rmtree(os.path.join(pub_dir, "publish-2"))
    with pytest.raises(RuntimeError, match="gap"):
        resolve_chain(pub_dir)
    with open(os.path.join(pub_dir, "publish-3",
                           online.publish.MANIFEST)) as f:
        manifest = json.load(f)
    assert manifest["kind"] == "delta" and manifest["base_version"] == 1


# ------------------------------------------------------ across the packages --

def _publish_chain(pkg, pub_dir, seed=4, steps=3):
    """Three intervals of (_touch, dense + 1) through ``pkg``'s publisher:
    (train table, last dense state)."""
    if pkg is pfluid:
        Table, Adagrad, Pub = HostSparseTable, HostAdagrad, DeltaPublisher
    else:
        from paddle_tpu.hostps.optimizer import HostAdagrad as Adagrad
        from paddle_tpu.hostps.table import HostSparseTable as Table
        Pub = jfluid.online.DeltaPublisher
    rng = np.random.RandomState(seed)
    table = Table(96, 6, seed=7, name="ctr", optimizer=Adagrad())
    pub = Pub(pub_dir, hostps=[table])
    state = {"w": rng.randn(4, 3).astype(np.float32),
             "b": rng.randn(3).astype(np.float32)}
    for step in range(1, steps + 1):
        _touch(table, rng, k=15)
        state = {k: v * 1.5 for k, v in state.items()}
        assert pub.publish(state, step=step) == step
    return table, state


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_chain_resolves_and_applies_in_the_other_package(writer, tmp_path):
    wpkg, rpkg = (jfluid, pfluid) if writer == "jax" else (pfluid, jfluid)
    pub_dir = str(tmp_path / "chain")
    table, state = _publish_chain(wpkg, pub_dir)
    ro = rpkg.online
    chain = ro.resolve_chain(pub_dir)
    assert [v for v, _p, _m in chain] == [1, 2, 3]
    rows, arrays = ro.load_chain_rows(chain, "ctr")
    ref_rows, ref_arrays, _m = table.snapshot()
    np.testing.assert_array_equal(rows, ref_rows)
    for key in ref_arrays:
        np.testing.assert_array_equal(arrays[key], ref_arrays[key])
    dense = ro.publish.load_chain_dense(
        chain, {"dense": {k: np.zeros_like(v) for k, v in state.items()}})
    for k in state:
        np.testing.assert_array_equal(np.asarray(dense["dense"][k]), state[k])
    if rpkg is pfluid:
        serve = HostSparseTable(96, 6, seed=7, name="ctr",
                                optimizer=HostAdagrad())
    else:
        from paddle_tpu.hostps.optimizer import HostAdagrad as JAdagrad
        from paddle_tpu.hostps.table import HostSparseTable as JTable
        serve = JTable(96, 6, seed=7, name="ctr", optimizer=JAdagrad())
    serve.adopt_rows(rows, arrays)
    probe = np.arange(96, dtype=np.int64)
    np.testing.assert_array_equal(serve.pull(probe, materialize=False),
                                  table.pull(probe, materialize=False))


# --------------------------------------------------------- swapper (engine) --

@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The smoke model (x[12] + emb[16]) saved by the JAX package and
    exported by each: (port dir, JAX dir)."""
    saved = serve_bench.build_artifact(
        jfluid, str(tmp_path_factory.mktemp("saved")),
        np.random.RandomState(0), exported=False)
    pdir = str(tmp_path_factory.mktemp("port_export"))
    jdir = str(tmp_path_factory.mktemp("jax_export"))
    for d in (pdir, jdir):
        shutil.copytree(saved, d, dirs_exist_ok=True)
    serve_bench.export(pfluid, pdir, {"x": (4, 12), "emb": (4, 16)}, "cpu")
    serve_bench.export(jfluid, jdir, {"x": (4, 12), "emb": (4, 16)})
    return pdir, jdir


def _side(pkg, dirname, pub_dir, name, vocab=64):
    """One package's serving replica: (engine, predictor, swapper, serving
    table) over a read-only 'serve_ctr' table of ``vocab`` x 4."""
    if pkg is pfluid:
        ep = load_exported_model(dirname, device="cpu")
        table = HostSparseTable(vocab, 4, seed=11, name="serve_ctr")
        emb = HostPSEmbedding(table, cache_slots=16, read_only=True,
                              device="cpu")
        sv, on = pfluid.serving, online
    else:
        from paddle_tpu.hostps.service import HostPSEmbedding as JEmb
        from paddle_tpu.hostps.table import HostSparseTable as JTable

        ep = jfluid.inference.load_exported_model(dirname)
        table = JTable(vocab, 4, seed=11, name="serve_ctr")
        emb = JEmb(table, cache_slots=16, read_only=True)
        sv, on = jfluid.serving, jfluid.online
    eng = sv.ServeEngine(ep, sv.BucketLattice([4, 8]), feed_spec=FEED_SPEC,
                         lookups=[sv.CTRLookup(emb, "ids", out_name="emb")],
                         name=name)
    return eng, ep, on.VersionSwapper(eng, ep, pub_dir, hostps=[emb]), table


def _probe(rng, rows, vocab=64):
    return {"x": rng.rand(rows, 12).astype("f4"),
            "ids": rng.randint(0, vocab, size=(rows, 4)).astype("i8")}


def test_version_swapper_chain_flip_and_rollback(artifacts, tmp_path):
    """Publish base + delta from a training table, flip a LIVE engine to
    each under load, zero captures, then roll back."""
    pdir, _ = artifacts
    rng = np.random.RandomState(5)
    pub_dir = str(tmp_path / "chain")
    train_table = HostSparseTable(64, 4, seed=11, name="serve_ctr")
    pub = DeltaPublisher(pub_dir, hostps=[train_table])
    eng, ep, swapper, serve_table = _side(pfluid, pdir, pub_dir, "swap_e2e")

    _touch(train_table, rng)
    v1_state = {n: v.numpy() * 1.5 for n, v in ep._state.items()}
    assert pub.publish(v1_state, step=2, train_wall=time.time()) == 1
    with eng:
        ev1 = swapper.apply(1)
        assert ev1["kind"] == "base" and ev1["chain_len"] == 1
        assert ev1["freshness_lag_s"] >= 0
        assert ev1["preverified"] == {"cached": 2}
        r, a, _m = train_table.snapshot()
        np.testing.assert_array_equal(
            serve_table.pull(r.reshape(-1, 1)).reshape(r.size, -1),
            a["param"])
        for n in v1_state:
            np.testing.assert_array_equal(ep._state[n].numpy(), v1_state[n])
        _touch(train_table, rng)
        v2_state = {n: v * 2.0 for n, v in v1_state.items()}
        assert pub.publish(v2_state, step=4, train_wall=time.time()) == 2
        ev2 = swapper.poll()
        assert ev2["version"] == 2 and ev2["kind"] == "delta"
        assert swapper.poll() is None
        r, a, _m = train_table.snapshot()
        np.testing.assert_array_equal(
            serve_table.pull(r.reshape(-1, 1)).reshape(r.size, -1),
            a["param"])
        futs = [eng.submit(_probe(rng, 3)) for _ in range(4)]
        for f in futs:
            f.result(timeout=60)
        ev_rb = swapper.rollback()
        assert ev_rb["version"] == 1 and ev_rb["rollback"]
        assert swapper.version == 1
        for n in v1_state:
            np.testing.assert_array_equal(ep._state[n].numpy(), v1_state[n])
    s = eng.last_summary
    assert s["recompiles"] == 0 and s["new_compiled_sigs"] == 0
    assert s["completed"] == 4
    assert eng.stats.registry.counter("swap_e2e.swaps").value == 3


def test_swapper_refuses_unknown_version(artifacts, tmp_path):
    eng, ep, _sw, _t = _side(pfluid, artifacts[0], str(tmp_path / "x"),
                             "swap_none")
    swapper = VersionSwapper(eng, ep, str(tmp_path / "nochain"))
    with pytest.raises(ValueError, match="no committed publish chain"):
        swapper.apply(3)
    assert swapper.poll() is None


def test_rollback_forgets_rows_the_target_never_held(artifacts, tmp_path):
    """A row first trained in version 2 serves its trained value after the
    flip to 2 and its initializer value again after the rollback to 1 —
    exactly what a fresh replica applying version 1 serves."""
    pdir, _ = artifacts
    pub_dir = str(tmp_path / "chain")
    train = HostSparseTable(64, 4, seed=11, name="serve_ctr")
    pub = DeltaPublisher(pub_dir, hostps=[train])
    eng, ep, swapper, serve_table = _side(pfluid, pdir, pub_dir, "forget")
    dense = {n: v.numpy() for n, v in ep._state.items()}
    train.pull(np.array([3, 5]))
    train.push(np.array([3, 5]), np.ones((2, 4), np.float32), 0.5)
    pub.publish(dense, step=1)
    train.pull(np.array([9]))
    train.push(np.array([9, 3]), np.ones((2, 4), np.float32), 0.5)
    pub.publish(dense, step=2)
    fresh = HostSparseTable(64, 4, seed=11, name="serve_ctr")
    with eng:
        assert swapper.apply(1)["rows_installed"] == 2
        v1_rows = serve_table.pull(np.arange(64), materialize=False)
        ev = swapper.poll()
        assert ev["rows_installed"] == 3 and ev["rows_forgotten"] == 0
        assert serve_table.rows_initialized == 3
        ev = swapper.rollback()
        assert ev["rows_installed"] == 2 and ev["rows_forgotten"] == 1
    assert serve_table.rows_initialized == 2 and not serve_table._live[9]
    np.testing.assert_array_equal(
        serve_table.pull(np.arange(64), materialize=False), v1_rows)
    np.testing.assert_array_equal(v1_rows[9],
                                  fresh.pull(np.array([9]))[0])


def _loop(pkg, dirname, pub_dir, seed):
    """The whole loop in one package: a trainer table takes three
    intervals of pushes, each published (base, delta, delta) and flipped
    onto a live continuous engine while a client thread keeps submitting;
    then a rollback to version 2.  After each flip (and the rollback) the
    client pauses and the same probe requests are served alone.  Returns
    ({version label: [probe outputs]}, [flip events], summary)."""
    if pkg is pfluid:
        train = HostSparseTable(64, 4, seed=11, name="serve_ctr")
        Pub = DeltaPublisher
    else:
        from paddle_tpu.hostps.table import HostSparseTable as JTable

        train = JTable(64, 4, seed=11, name="serve_ctr")
        Pub = jfluid.online.DeltaPublisher
    pub = Pub(pub_dir, hostps=[train])
    eng, ep, swapper, _serve = _side(pkg, dirname, pub_dir, "loop")
    base = {n: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for n, v in ep._state.items()}
    rng = np.random.RandomState(seed)
    probes = [_probe(np.random.RandomState(100 + i), r)
              for i, r in enumerate((1, 3, 8))]
    load_rng = np.random.RandomState(seed + 1)
    load = [_probe(load_rng, int(load_rng.randint(1, 6))) for _ in range(64)]
    go, stop, futs = threading.Event(), threading.Event(), []
    gate = threading.Lock()

    def client():
        k = 0
        while not stop.is_set():
            if not go.wait(0.01):
                continue
            with gate:
                if go.is_set():
                    futs.append(eng.submit(load[k % len(load)]))
                    k += 1
            time.sleep(0.002)

    def serve_probes():
        go.clear()
        with gate:                 # no submit is half done
            pending = list(futs)
        for f in pending:
            f.result(timeout=60)
        out = [eng.submit(dict(p)).result(timeout=60)[0] for p in probes]
        go.set()
        return out

    outs, events = {}, []
    with eng:
        t = threading.Thread(target=client)
        t.start()
        go.set()
        try:
            for step in (1, 2, 3):
                _touch(train, rng, k=10)
                state = {n: v * (1.0 + 0.25 * step) for n, v in base.items()}
                assert pub.publish(state, step=step) == step
                events.append(swapper.poll())
                outs[step] = serve_probes()
            events.append(swapper.rollback())
            outs["rollback"] = serve_probes()
        finally:
            stop.set()
            t.join()
        for f in futs:
            f.result(timeout=60)
    return outs, events, eng.last_summary, len(futs)


def test_the_whole_loop_agrees_with_the_jax_package(artifacts, tmp_path):
    pdir, jdir = artifacts
    pout, pev, psum, pn = _loop(pfluid, pdir, str(tmp_path / "p"), seed=31)
    jout, jev, jsum, jn = _loop(jfluid, jdir, str(tmp_path / "j"), seed=31)
    for key in (1, 2, 3):
        for got, want in zip(pout[key], jout[key]):
            np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                       atol=ATOL)
    for a, b in zip(pev[:3], jev[:3]):
        for k in ("version", "kind", "chain_len", "rows_installed",
                  "train_step"):
            assert a[k] == b[k], k
    assert [e["version"] for e in pev] == [1, 2, 3, 2]
    assert all(e["preverified"] == {"cached": 2} for e in pev)
    # the rollback serves version 2 exactly: bit for bit the port's own
    # version-2 outputs, and the JAX package's within the tolerance
    for got, v2, jv2 in zip(pout["rollback"], pout[2], jout[2]):
        np.testing.assert_array_equal(got, v2)
        np.testing.assert_allclose(got, np.asarray(jv2), rtol=RTOL,
                                   atol=ATOL)
    assert psum["recompiles"] == 0 and psum["new_compiled_sigs"] == 0
    assert psum["completed"] == pn + 12 and jsum["completed"] == jn + 12


def test_deepfm_online_leg_publishes_in_the_artifact_names(tmp_path):
    """The host-table DeepFM's online leg at small widths: a trainer takes
    ``deepfm_hostps.train_step`` steps on its own table, every second step
    is published in ``serve_bench.deepfm_params``' names and flipped onto
    a live engine over ``build_deepfm_artifact``'s artifact; each version
    serves the probe within the derived bound of ``_deepfm_head`` with that
    step's dense tree on the trainer's rows, and a rollback serves
    version 1 bit for bit."""
    from paddle_tpu_torch.tools import deepfm_hostps as dh

    F, D, mlp, vocab = 4, 3, (8, 8), 5000
    rng = np.random.RandomState(12)
    dense = dh.init_dense(torch.Generator().manual_seed(3), F, D, mlp, "cpu")
    art = serve_bench.build_deepfm_artifact(
        pfluid, str(tmp_path / "art"), serve_bench.deepfm_params(dense), F,
        D, mlp, device="cpu")
    trainer = dh.make_embedding(vocab, D, 16, device="cpu",
                                name=serve_bench.TABLE_NAME)
    stable, semb, lookup = serve_bench.make_deepfm_lookup(vocab, D, 16,
                                                          "cpu")
    ep = load_exported_model(art, device="cpu")
    eng = ServeEngine(ep, BucketLattice([2, 4, 8]),
                      feed_spec={"emb": ((F * (D + 1),), "float32")},
                      lookups=[lookup], name="deepfm_online")
    pub_dir = str(tmp_path / "publish")
    pub = DeltaPublisher(pub_dir, hostps=[trainer])
    probe = {"ids": dh.zipf_ids(rng, 5, F, vocab)}
    outs = {}
    with eng:
        swapper = VersionSwapper(eng, ep, pub_dir, hostps=[semb])
        for step in range(1, 5):
            ids = dh.zipf_ids(rng, 32, F, vocab)
            _loss, dense = dh.train_step(trainer, dense, ids, dh.labels(ids),
                                         0.05, "host")
            if step % 2:
                continue
            state = serve_bench.deepfm_params(dense)
            version = pub.publish(state, step=step)
            ev = swapper.poll()
            assert ev["version"] == version
            assert ev["preverified"] == {"cached": 3}
            outs[version] = eng.submit(dict(probe)).result(timeout=60)[0]
            ref, bound = serve_bench.deepfm_head_bounds(
                state, trainer.table.pull(probe["ids"], materialize=False), D)
            assert serve_bench._hold(outs[version], ref, bound)["ok"]
        assert swapper.rollback()["version"] == 1
        back = eng.submit(dict(probe)).result(timeout=60)[0]
    np.testing.assert_array_equal(back, outs[1])
    assert not np.array_equal(outs[1], outs[2])
    s = eng.last_summary
    assert s["recompiles"] == 0 and s["new_compiled_sigs"] == 0
    rows, _arrays = load_chain_rows(resolve_chain(pub_dir, 1),
                                    serve_bench.TABLE_NAME)
    assert stable.rows_initialized == len(rows)
