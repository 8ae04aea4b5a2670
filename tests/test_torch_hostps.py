"""HostPS in the port (``paddle_tpu_torch/hostps``) held to the JAX
package's ``paddle_tpu/hostps`` on the same numpy inputs.

Every test of ``tests/test_hostps.py`` that is not marked slow is here,
each against the JAX object where both packages have one, and the slow
``test_multi_gib_host_table_stress`` stays slow.  Tables are numpy in both
packages, so the initializer, pulls and the SGD / Adagrad / Adam pushes
match bit for bit; ``pull_unique``'s rows, inverse and values too.  The
merged push (``push_in_jit(merge=True)``: the segment-sum kernel's plain
version here, JAX's Pallas kernel in interpret mode) sums duplicate rows
in another order than JAX's, so both tables are held to the float64
update within ``tools/fp_bounds.py`` ``host_sgd_update``'s derived bound.
``tools/deepfm_hostps.py`` at a tiny width is held to a JAX step built
from ``paddle_tpu.models.deepfm._deepfm_head``: losses at rtol 1e-5, the
two push routes to each other within the derived bound.  Added: a
prefetch overtaken by pushes returns what a synchronous pull would, a
read-only embedding refuses every push, and ``convert``'s table
converter round trip.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import hostps as jhostps
from paddle_tpu import profiler as jprof
from paddle_tpu.hostps import service as jservice
from paddle_tpu.parallel import embedding as jemb
from paddle_tpu_torch import convert
from paddle_tpu_torch import profiler as prof
from paddle_tpu_torch.hostps import (
    HostAdagrad,
    HostAdam,
    HostPSEmbedding,
    HostSGD,
    HostSparseTable,
    HotRowCache,
)
from paddle_tpu_torch.hostps import service as hostps_service
from paddle_tpu_torch.parallel import embedding as emb
from paddle_tpu_torch.tools import deepfm_hostps as dh
from paddle_tpu_torch.tools import fp_bounds

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _hostps_state():
    """Isolate the routing flags, budgets, prefetch hooks, profiler
    counters and the live-embedding registry of both packages."""
    old = [(m._HBM_BYTES_PER_CHIP, m._HBM_TABLE_FRACTION,
            m.host_sparse_table_enabled()) for m in (emb, jemb)]
    prof.reset_profiler()
    jprof.reset_profiler()
    yield
    for m, (b, f, flag) in zip((emb, jemb), old):
        m._HBM_BYTES_PER_CHIP, m._HBM_TABLE_FRACTION = b, f
        m.enable_host_sparse_table(flag)
    hostps_service._PREFETCH_HOOKS.clear()
    jservice._PREFETCH_HOOKS.clear()
    hostps_service._LIVE_EMBEDDINGS.clear()
    jservice._LIVE_EMBEDDINGS.clear()
    prof.reset_profiler()
    jprof.reset_profiler()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _twins(vocab, dim, seed, optimizer="sgd", **kw):
    mk = {"sgd": lambda m: m.HostSGD(), "adagrad": lambda m: m.HostAdagrad(),
          "adam": lambda m: m.HostAdam()}[optimizer]
    import paddle_tpu_torch.hostps as phostps

    return (phostps.HostSparseTable(vocab, dim, optimizer=mk(phostps),
                                    seed=seed, **kw),
            jhostps.HostSparseTable(vocab, dim, optimizer=mk(jhostps),
                                    seed=seed, **kw))


def _same_state(p, j):
    pr, pa, pm = p.snapshot()
    jr, ja, jm = j.snapshot()
    np.testing.assert_array_equal(pr, jr)
    assert pm == jm and sorted(pa) == sorted(ja)
    for k in pa:
        np.testing.assert_array_equal(pa[k], ja[k], err_msg=k)


# -- table semantics ---------------------------------------------------------

def test_init_on_first_pull_deterministic():
    """A row's init depends only on (seed, row): pull order, batching, a
    second instance and the JAX package's table all see the same bits;
    only touched rows materialize."""
    a, ja = _twins(10_000, 6, 42)
    b = HostSparseTable(10_000, 6, seed=42)
    va = a.pull(np.array([7, 9999, 3]))
    vb = b.pull(np.array([3]))
    vb2 = b.pull(np.array([9999, 7]))
    np.testing.assert_array_equal(va[2], vb[0])
    np.testing.assert_array_equal(va[0], vb2[1])
    np.testing.assert_array_equal(va[1], vb2[0])
    np.testing.assert_array_equal(va, ja.pull(np.array([7, 9999, 3])))
    assert a.rows_initialized == ja.rows_initialized == 3
    c = HostSparseTable(10_000, 6, seed=43)
    assert not np.allclose(c.pull(np.array([7])), va[0])
    # np.zeros (calloc) backing: untouched rows cost address space only
    assert a.nbytes_virtual == ja.nbytes_virtual
    assert a.nbytes_resident == ja.nbytes_resident


def test_pull_oob_returns_zeros_and_push_drops_sentinel():
    t, jt = _twins(100, 4, 0)
    out = t.pull(np.array([-1, 100, 5]))
    np.testing.assert_array_equal(out, jt.pull(np.array([-1, 100, 5])))
    assert (out[0] == 0).all() and (out[1] == 0).all()
    assert not (out[2] == 0).all()
    before = t.pull(np.array([5])).copy()
    rows = np.array([5, 5, 100])
    grads = np.ones((3, 4), np.float32)
    r, new = t.push(rows, grads, lr=0.1)
    jr, jnew = jt.push(rows, grads, lr=0.1)
    np.testing.assert_array_equal(r, [5])
    np.testing.assert_array_equal(new, jnew)
    np.testing.assert_allclose(t.pull(np.array([5]))[0],
                               before[0] - 0.1 * 2.0, rtol=1e-6)
    assert t.rows_initialized == 1
    _same_state(t, jt)


def test_host_appliers_match_numpy_reference():
    """Each applier's rows-only update against a numpy transcript, and bit
    for bit against the JAX package's table."""
    rng = np.random.RandomState(0)
    dim = 5
    g1 = rng.randn(3, dim).astype(np.float32)
    g2 = rng.randn(3, dim).astype(np.float32)

    def run(optimizer):
        t, jt = _twins(50, dim, 1, optimizer)
        rows = np.array([4, 7, 9])
        p0 = t.pull(rows).astype(np.float64)
        jt.pull(rows)
        for g in (g1, g2):
            t.push(rows, g, 0.05)
            jt.push(rows, g, 0.05)
        _same_state(t, jt)
        return p0, t.pull(rows)

    p0, got = run("sgd")
    np.testing.assert_allclose(got, p0 - 0.05 * (g1 + g2), rtol=1e-5)
    eps = 1e-6
    p0, got = run("adagrad")
    m = g1 * g1
    ref = p0 - 0.05 * g1 / (np.sqrt(m) + eps)
    m = m + g2 * g2
    ref = ref - 0.05 * g2 / (np.sqrt(m) + eps)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    b1, b2, eps = 0.9, 0.999, 1e-8
    p0, got = run("adam")
    m = v = np.zeros_like(g1)
    ref = p0
    for step, g in ((1, g1), (2, g2)):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        scale = 0.05 * np.sqrt(1 - b2 ** step) / (1 - b1 ** step)
        ref = ref - scale * m / (np.sqrt(v) + eps)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=2e-6)


def test_adam_lazy_per_row_step():
    """A row first seen late gets the step-1 bias correction (lazy adam)."""
    t = HostSparseTable(20, 3, optimizer=HostAdam(), seed=2)
    g = np.full((1, 3), 0.5, np.float32)
    t.push(np.array([1]), g, 0.1)
    t.push(np.array([1]), g, 0.1)
    early = t.pull(np.array([2])).copy()
    t.push(np.array([2]), g, 0.1)
    fresh = HostSparseTable(20, 3, optimizer=HostAdam(), seed=2)
    fresh.pull(np.array([2]))
    fresh.push(np.array([2]), g, 0.1)
    np.testing.assert_array_equal(t.pull(np.array([2])),
                                  fresh.pull(np.array([2])))
    assert not np.allclose(early, t.pull(np.array([2])))


# -- capacity router ---------------------------------------------------------

def test_router_routes_beyond_budget_to_hostps():
    emb.configure_hbm_budget(1024, table_fraction=0.5)
    gen = torch.Generator().manual_seed(0)
    small = emb.init_embedding_table(gen, 8, 4, n_shards=1, device=CPU)
    assert isinstance(small, torch.Tensor) and small.shape == (8, 4)
    with pytest.raises(ValueError) as ei:
        emb.init_embedding_table(gen, 4096, 16, n_shards=1, device=CPU)
    assert "use_host_sparse_table" in str(ei.value)
    assert "hostps" in str(ei.value)
    emb.enable_host_sparse_table(True)
    h = emb.init_embedding_table(gen, 4096, 16, n_shards=1, cache_slots=8,
                                 host_optimizer=HostSGD(), device=CPU)
    assert isinstance(h, HostPSEmbedding)
    assert h.vocab_size == 4096 and h.dim == 16 and h.cache is not None
    assert h.pull(np.array([1])).device == torch.device("cpu")
    # the JAX route's rows for PRNGKey(0) are this route's for seed 0
    jemb.configure_hbm_budget(1024, table_fraction=0.5)
    jemb.enable_host_sparse_table(True)
    j = jemb.init_embedding_table(jax.random.PRNGKey(0), 4096, 16,
                                  n_shards=1, cache_slots=8,
                                  host_optimizer=jhostps.HostSGD())
    ids = np.array([0, 17, 4095])
    np.testing.assert_array_equal(_np(h.pull(ids)), np.asarray(j.pull(ids)))


def test_capacity_guard_message_names_knob():
    with pytest.raises(ValueError, match="use_host_sparse_table"):
        emb.configure_hbm_budget(16 << 30)
        emb.init_sharded_table(torch.Generator(), vocab_size=2_000_000_000,
                               dim=64, n_shards=4, device=CPU)


def test_fleet_strategy_knob_flips_router():
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.distributed import fleet as fleet_mod

    assert not emb.host_sparse_table_enabled()
    strategy = fleet_mod.DistributedStrategy()
    strategy.use_host_sparse_table = True
    fleet_mod.fleet.distributed_optimizer(fluid.optimizer.SGD(0.1), strategy)
    assert emb.host_sparse_table_enabled()


# -- training parity ---------------------------------------------------------

def _parity_data(vocab, fields, batch, steps, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, (batch, fields)).astype(np.int64),
             rng.randn(batch).astype(np.float32)) for _ in range(steps)]


def _dense_losses(table0, w, data, lr, optimizer):
    """The table in device memory: a full [V, D] tensor, its dense
    gradient and update (adagrad's dense moment equals the lazy one:
    untouched rows have zero gradient)."""
    table = torch.from_numpy(table0.copy())
    moment = torch.zeros_like(table)
    wt = torch.from_numpy(w)
    losses = []
    for ids, label in data:
        t = table.clone().requires_grad_()
        pred = torch.einsum("bfd,d->b", t[torch.from_numpy(ids)], wt)
        loss = ((pred - torch.from_numpy(label)) ** 2).mean()
        (g,) = torch.autograd.grad(loss, [t])
        if optimizer == "sgd":
            table = table - lr * g
        else:
            moment = moment + g * g
            table = table - lr * g / (moment.sqrt() + 1e-6)
        losses.append(float(loss.detach()))
    return losses, table.numpy()


def _hostps_losses(svc, w, data, lr):
    wt = torch.from_numpy(w)
    losses = []
    for ids, label in data:
        rows, values, inv = svc.pull_unique(ids)
        values.requires_grad_()
        pred = torch.einsum("bfd,d->b", values[torch.from_numpy(inv)], wt)
        loss = ((pred - torch.from_numpy(label)) ** 2).mean()
        (g,) = torch.autograd.grad(loss, [values])
        svc.push(rows, g[:rows.shape[0]], lr)
        losses.append(float(loss.detach()))
    return losses


def _jax_hostps_losses(svc, w, data, lr):
    w = jnp.asarray(w)

    @jax.jit
    def step(values, inv, label):
        def loss_fn(v):
            pred = jnp.einsum("bfd,d->b", v[inv], w)
            return jnp.mean((pred - label) ** 2)
        return jax.value_and_grad(loss_fn)(values)

    losses = []
    for ids, label in data:
        rows, values, inv = svc.pull_unique(ids)
        loss, g = step(values, jnp.asarray(inv), jnp.asarray(label))
        svc.push(rows, np.asarray(g[:rows.shape[0]]), lr)
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_beyond_budget_training_parity(optimizer):
    """Tiny budget -> the router sends the table to HostPS; training there
    matches the table held in device memory and the JAX package's HostPS
    to atol 1e-5 on the same data and the same initial rows."""
    n, vocab, dim, fields, batch, steps, lr = 8, 96, 8, 3, 16, 6, 0.1
    table0 = (np.random.RandomState(5).randn(vocab, dim)
              / np.sqrt(dim)).astype(np.float32)
    w = np.random.RandomState(1).randn(dim).astype(np.float32)
    data = _parity_data(vocab, fields, batch, steps)
    losses_dense, table_dense = _dense_losses(table0, w, data, lr, optimizer)

    emb.configure_hbm_budget(64, table_fraction=0.5)
    assert not emb.table_fits(vocab, dim, n_shards=n)
    emb.enable_host_sparse_table(True)
    host_opt = HostSGD() if optimizer == "sgd" else HostAdagrad(epsilon=1e-6)
    svc = emb.init_embedding_table(
        None, vocab, dim, n_shards=n, host_optimizer=host_opt,
        host_initializer=lambda rows: table0[rows], cache_slots=24,
        device=CPU)
    assert isinstance(svc, HostPSEmbedding)
    losses_ps = _hostps_losses(svc, w, data, lr)
    jopt = (jhostps.HostSGD() if optimizer == "sgd"
            else jhostps.HostAdagrad(epsilon=1e-6))
    jsvc = jhostps.HostPSEmbedding(
        jhostps.HostSparseTable(vocab, dim, optimizer=jopt,
                                initializer=lambda rows: table0[rows]),
        cache_slots=24)
    losses_j = _jax_hostps_losses(jsvc, w, data, lr)

    np.testing.assert_allclose(losses_ps, losses_dense, atol=1e-5)
    np.testing.assert_allclose(losses_ps, losses_j, atol=1e-5)
    touched = np.unique(np.concatenate([ids.ravel() for ids, _ in data]))
    got = _np(svc.pull(touched, use_cache=False))
    np.testing.assert_allclose(got, table_dense[touched], atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jsvc.pull(touched)),
                               atol=1e-5)
    assert prof.counters().get("hostps.cache.hit", 0) > 0


# -- hot-ID cache ------------------------------------------------------------

def test_cache_evict_refill_matches_bypass_and_counters():
    """4-slot cache over a 12-row working set: every pull forces evictions
    and refills, and equals the cache-bypassed pull and the JAX service's
    pull; hit/miss/evict counts match JAX's and reach the profiler."""
    svc = HostPSEmbedding(HostSparseTable(64, 5, optimizer=HostSGD(), seed=9),
                          cache_slots=4, device=CPU)
    jsvc = jhostps.HostPSEmbedding(
        jhostps.HostSparseTable(64, 5, optimizer=jhostps.HostSGD(), seed=9),
        cache_slots=4)
    rng = np.random.RandomState(2)
    for step in range(12):
        ids = rng.randint(0, 12, (7,))
        got = _np(svc.pull(ids))
        np.testing.assert_array_equal(got, _np(svc.pull(ids, use_cache=False)))
        np.testing.assert_array_equal(got, np.asarray(jsvc.pull(ids)))
        jsvc.pull(ids, use_cache=False)
        if step % 3 == 2:
            rows = np.unique(ids)
            g = rng.randn(rows.size, 5).astype(np.float32)
            svc.push(rows, g, 0.05)
            jsvc.push(rows, g, 0.05)
    c, jc = prof.counters(), jprof.counters()
    for k in ("hostps.cache.hit", "hostps.cache.miss", "hostps.cache.evict"):
        assert c[k] > 0 and c[k] == jc[k], k
    assert svc.cache.hits == c["hostps.cache.hit"]
    names = {r["name"] for r in prof.counter_report()}
    assert {"hostps.cache.hit", "hostps.cache.miss",
            "hostps.pull_ms"} <= names
    from paddle_tpu_torch.monitor.registry import default_registry

    gauges = {r["name"] for r in default_registry().snapshot()}
    assert {"hostps.cache.occupancy", "hostps.cache.hit_rate",
            "hostps.cache.hot_row_skew"} <= gauges


def test_cache_same_batch_rows_never_evict_each_other():
    cache = HotRowCache(3, 2, device=CPU)
    rows = np.arange(5)
    slots, hit = cache.lookup(rows)
    assert not hit.any()
    cache.insert(rows, np.ones((5, 2), np.float32))
    slots, hit = cache.lookup(rows)
    assert int(hit.sum()) == 3
    np.testing.assert_allclose(_np(cache.gather(slots[hit])), 1.0)
    assert cache.nbytes == 3 * 2 * 4


def test_memscope_counts_the_cache_and_the_tables():
    """MemScope's ``hostps_cache`` owner is each live embedding's slot
    buffer, and its host accounting sums the tables' resident bytes, as
    the reference's do."""
    from paddle_tpu_torch.monitor import memscope

    svc = HostPSEmbedding(HostSparseTable(1000, 6, seed=1, name="ms_a"),
                          cache_slots=16, device=CPU)
    other = HostPSEmbedding(HostSparseTable(500, 2, seed=1, name="ms_b"),
                            device=CPU)
    svc.pull(np.arange(40))
    other.pull(np.arange(7))
    owners = memscope.attribution()["owners"]
    assert owners["hostps_cache"] == svc.cache.nbytes == 16 * 6 * 4
    host = memscope.host_accounting()
    assert host["hostps_tables_bytes"] == (svc.table.nbytes_resident
                                           + other.table.nbytes_resident)
    assert svc.table.nbytes_resident == 40 * 6 * 4 + 1000


# -- pull_unique against JAX -------------------------------------------------

def test_pull_unique_matches_jax_bit_for_bit():
    svc = HostPSEmbedding(HostSparseTable(500, 3, seed=5), cache_slots=16,
                          device=CPU)
    jsvc = jhostps.HostPSEmbedding(jhostps.HostSparseTable(500, 3, seed=5),
                                   cache_slots=16)
    rng = np.random.RandomState(4)
    for _ in range(3):
        ids = rng.randint(-3, 503, (6, 5))
        r, v, inv = svc.pull_unique(ids)
        jr, jv, jinv = jsvc.pull_unique(ids)
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(inv, jinv)
        np.testing.assert_array_equal(_np(v), np.asarray(jv))
        assert v.shape == (r.shape[0] + 1, 3)


# -- prefetch pipeline -------------------------------------------------------

def test_prefetch_matches_sync_and_counts():
    svc = HostPSEmbedding(HostSparseTable(200, 4, seed=4), cache_slots=8,
                          device=CPU)
    ids = np.array([[3, 5], [90, 3]])
    ref = _np(svc.pull(ids, use_cache=False))
    svc.prefetch(ids)
    np.testing.assert_array_equal(_np(svc.pull(ids)), ref)
    assert prof.counters().get("hostps.prefetch.hit") == 1
    svc.prefetch(np.array([1, 2]))
    svc.prefetch(np.array([7, 8]))
    np.testing.assert_array_equal(
        _np(svc.pull(np.array([1, 2]))),
        _np(svc.pull(np.array([1, 2]), use_cache=False)))
    assert prof.counters().get("hostps.prefetch.hit") == 2
    assert prof.counters().get("hostps.prefetch.waste") is None
    svc.prefetch(np.array([11, 12]))
    svc.prefetch(np.array([13, 14]))
    svc.prefetch(np.array([15, 16]))
    assert prof.counters().get("hostps.prefetch.waste") == 2


def test_prefetch_survives_trainer_announce_pattern():
    svc = HostPSEmbedding(HostSparseTable(100, 4, seed=12), cache_slots=8,
                          device=CPU)
    batches = [np.array([i, i + 1, i + 2]) for i in range(0, 15, 3)]
    svc.prefetch(batches[0])
    for k, ids in enumerate(batches):
        if k + 1 < len(batches):
            svc.prefetch(batches[k + 1])
        np.testing.assert_array_equal(
            _np(svc.pull(ids)), _np(svc.pull(ids, use_cache=False)))
    assert prof.counters().get("hostps.prefetch.hit") == len(batches)
    assert prof.counters().get("hostps.prefetch.waste") is None


def test_prefetch_overtaken_by_pushes_is_exact():
    """Pushes landing while a prefetch is pending are written over its
    values: a prefetched pull returns what a synchronous pull at the same
    point returns (a restore in between discards the prefetch).  The
    interpreter switches threads every microsecond here, so the prefetch
    thread's reads interleave with the pushes."""
    import sys

    rng = np.random.RandomState(6)
    a = HostPSEmbedding(HostSparseTable(60, 3, seed=8, name="pf_a"),
                        cache_slots=10, device=CPU)
    b = HostPSEmbedding(HostSparseTable(60, 3, seed=8, name="pf_b"),
                        cache_slots=10, device=CPU)
    batches = [rng.randint(0, 60, (4, 3)) for _ in range(40)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for k, ids in enumerate(batches):
            ra, va, _ = a.pull_unique(ids)
            if k + 1 < len(batches):
                a.prefetch(batches[k + 1])
            rb, vb, _ = b.pull_unique(ids)
            np.testing.assert_array_equal(_np(va), _np(vb))
            g = rng.randn(ra.shape[0], 3).astype(np.float32)
            a.push(ra, g, 0.3)
            b.push(rb, g, 0.3)
    finally:
        sys.setswitchinterval(old)
    assert prof.counters().get("hostps.prefetch.hit") == len(batches) - 1
    with tempfile.TemporaryDirectory() as td:
        a.save(td)
        a.prefetch(batches[0])
        a.push(np.array([1, 2]), np.ones((2, 3), np.float32), 1.0)
        a.restore(td)
        np.testing.assert_array_equal(
            _np(a.pull(batches[0])), _np(a.pull(batches[0], use_cache=False)))
    assert prof.counters().get("hostps.prefetch.stale") == 1


def test_trainer_lookahead_announces_next_batch():
    from paddle_tpu_torch import trainer

    seen = []
    hostps_service.register_prefetch_hook(
        lambda feed: seen.append(int(feed["ids"][0])))
    feeds = [{"ids": np.array([i])} for i in range(4)]
    order = []
    for feed in trainer._iter_with_prefetch(iter(feeds)):
        order.append((int(feed["ids"][0]), list(seen)))
    assert [f for f, _ in order] == [0, 1, 2, 3]
    for cur, announced in order:
        assert announced == list(range(1, min(cur + 2, 4)))
    assert seen == [1, 2, 3]


def test_train_from_dataset_feeds_prefetcher():
    """A QueueDataset-driven train_from_dataset announces next batches to
    an attached HostPSEmbedding prefetch hook."""
    import paddle_tpu_torch as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data("ids", shape=[2], dtype="int64")
        label = fluid.layers.data("label", shape=[1], dtype="float32")
        embv = fluid.layers.embedding(ids, size=[50, 4])
        pred = fluid.layers.fc(fluid.layers.reduce_sum(embv, dim=1), 1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, label))
        fluid.optimizer.SGD(0.1).minimize(loss)

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "part-0")
        with open(path, "w") as f:
            for i in range(8):
                f.write("2 %d %d 1 0.5\n" % (i % 50, (i + 1) % 50))
        ds = fluid.DatasetFactory().create_dataset("QueueDataset")
        ds.set_batch_size(2)
        ds.set_use_var([ids, label])
        ds.set_filelist([path])
        assert ds.prefetch_id_slots() == ["ids"]
        svc = HostPSEmbedding(HostSparseTable(50, 4, seed=0), device=CPU)
        svc.attach_prefetch_slot(ds.prefetch_id_slots()[0])
        try:
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup)
            exe.train_from_dataset(main, ds)
        finally:
            svc.detach_prefetch_hooks()
        assert not hostps_service.has_prefetch_hooks()
    assert svc._pending
    assert svc.table.rows_initialized > 0


# -- push after backward (the reference's push from a jitted step) -----------

def test_push_from_jitted_step_io_callback():
    """``push_in_jit`` after backward: the plain push of per-unique-row
    gradients, and ``merge=True`` over per-occurrence gradients (the
    segment kernel's plain version here), against JAX's
    ``push_in_jit(merge=True)`` inside a jitted step (its Pallas kernel in
    interpret mode) on the same gradients: each table within the derived
    bound of the float64 update, the sentinel slots dropped."""
    vocab, dim, lr = 40, 3, 0.1
    svc = HostPSEmbedding(HostSparseTable(vocab, dim, optimizer=HostSGD(),
                                          seed=6), device=CPU)
    ids = np.array([4, 9, 4, 11])
    rows, values, inv = svc.pull_unique(ids)
    before = _np(values[:rows.shape[0]]).copy()
    values.requires_grad_()
    loss = (values[torch.from_numpy(inv)] ** 2).sum()
    (g,) = torch.autograd.grad(loss, [values])
    svc.push_in_jit(torch.from_numpy(rows), g[:rows.shape[0]], lr)
    real = rows >= 0
    assert real.sum() == 3 and (before[~real] == 0).all()
    counts = np.where(rows[real] == 4, 2.0, 1.0)[:, None]
    expect = before[real] - lr * 2.0 * counts * before[real]
    np.testing.assert_allclose(svc.table.pull(rows[real]), expect, rtol=1e-5)

    # merged: 96 per-occurrence gradients over 12 rows, both packages
    rng = np.random.RandomState(1)
    occ = rng.randint(0, 12, 96).astype(np.int64)
    occ[::17] = vocab                        # sentinel slots, dropped
    grads = rng.randn(96, dim).astype(np.float32)
    p, j = _twins(vocab, dim, 3)
    p0 = p.pull(np.arange(vocab)).copy()
    j.pull(np.arange(vocab))
    psvc = HostPSEmbedding(p, device=CPU)
    jsvc = jhostps.HostPSEmbedding(j)
    psvc.push_in_jit(torch.from_numpy(occ), torch.from_numpy(grads), lr,
                     merge=True)

    @jax.jit
    def jstep(r, v):
        jsvc.push_in_jit(r, v, lr, merge=True)
        return jnp.sum(v)

    jax.block_until_ready(jstep(jnp.asarray(occ, jnp.int32),
                                jnp.asarray(grads)))
    uniq, ref, bound = fp_bounds.host_sgd_update(p0, lr, occ, grads, vocab)
    for t in (p, j):
        r, _ = fp_bounds.ratio(t.pull(uniq), ref, bound)
        assert r <= 1.0, r
    assert p.rows_initialized == j.rows_initialized == vocab
    untouched = np.setdiff1d(np.arange(vocab), uniq)
    np.testing.assert_array_equal(p.pull(untouched), p0[untouched])
    with pytest.raises(ValueError, match="32-bit"):
        HostPSEmbedding(HostSparseTable(2 ** 31, 1), device=CPU).push_in_jit(
            torch.zeros(1, dtype=torch.long), torch.zeros(1, 1), lr,
            merge=True)


def test_read_only_embedding_refuses_pushes():
    t = HostSparseTable(30, 2, seed=1)
    svc = HostPSEmbedding(t, cache_slots=4, device=CPU, read_only=True)
    got = _np(svc.pull(np.array([3, 8])))
    np.testing.assert_array_equal(got, t.initializer(np.array([3, 8])))
    assert t.rows_initialized == 0
    for push in (lambda: svc.push(np.array([3]), np.ones((1, 2)), 0.1),
                 lambda: svc.push_in_jit(torch.tensor([3]), torch.ones(1, 2),
                                         0.1, merge=True)):
        with pytest.raises(RuntimeError, match="read-only"):
            push()


def test_push_selected_rows_merges_like_merge_rows():
    from paddle_tpu_torch.sparse import SelectedRows

    svc = HostPSEmbedding(HostSparseTable(30, 2, optimizer=HostSGD(), seed=7),
                          device=CPU)
    before = svc.table.pull(np.array([3, 8])).copy()
    sr = SelectedRows(torch.tensor([3, 8, 3, 30, 30]),
                      torch.ones((5, 2), dtype=torch.float32), height=30)
    out_rows, out_vals = sr.merged()
    svc.push_selected_rows(SelectedRows(out_rows, out_vals, 30), 0.5)
    got = svc.table.pull(np.array([3, 8]))
    np.testing.assert_allclose(got[0], before[0] - 0.5 * 2.0, rtol=1e-6)
    np.testing.assert_allclose(got[1], before[1] - 0.5 * 1.0, rtol=1e-6)


# -- checkpoint --------------------------------------------------------------

def test_checkpoint_roundtrip_table_and_moments():
    """save/restore through io.py sparse shards preserves param AND moment
    state; a shard written by either package restores in the other."""
    from paddle_tpu_torch import io as pio

    rng = np.random.RandomState(3)
    rows = np.array([2, 17, 33])
    g1 = rng.randn(3, 4).astype(np.float32)
    g2 = rng.randn(3, 4).astype(np.float32)
    a = HostSparseTable(64, 4, optimizer=HostAdagrad(), seed=8, name="emb")
    a.pull(rows)
    a.push(rows, g1, 0.1)
    with tempfile.TemporaryDirectory() as td:
        n_shards = pio.save_sparse_shards(
            td, "emb", np.nonzero(a._live)[0],
            {"param": a._param[a._live],
             "slot_moment": a._slots["moment"][a._live]},
            meta={"vocab_size": 64, "dim": 4, "dtype": "float32",
                  "optimizer": "adagrad"},
            rows_per_shard=2)
        assert n_shards == 2
        b = HostSparseTable(64, 4, optimizer=HostAdagrad(), seed=999,
                            name="emb")
        b.restore(td)
        jb = jhostps.HostSparseTable(64, 4, optimizer=jhostps.HostAdagrad(),
                                     seed=999, name="emb")
        jb.restore(td)
    with tempfile.TemporaryDirectory() as td:
        jb.save(td)
        c = HostSparseTable(64, 4, optimizer=HostAdagrad(), seed=5,
                            name="emb")
        c.restore(td)
    a.push(rows, g2, 0.1)
    for t in (b, jb, c):
        t.push(rows, g2, 0.1)
        np.testing.assert_array_equal(t.pull(rows), a.pull(rows))
        assert t.rows_initialized == a.rows_initialized


def test_service_save_restore_refreshes_cache():
    svc = HostPSEmbedding(HostSparseTable(32, 3, optimizer=HostSGD(), seed=10,
                                          name="t"), cache_slots=4, device=CPU)
    ids = np.array([1, 2, 3])
    want = _np(svc.pull(ids)).copy()
    with tempfile.TemporaryDirectory() as td:
        svc.save(td)
        svc.push(ids, np.ones((3, 3), np.float32), 1.0)
        svc.restore(td)
    np.testing.assert_array_equal(_np(svc.pull(ids)),
                                  _np(svc.pull(ids, use_cache=False)))
    np.testing.assert_array_equal(_np(svc.pull(ids)), want)


def test_convert_carries_a_table_between_packages():
    """``convert.table_from_snapshot``: a trained JAX table adopted by a
    port embedding (through ``install_rows``, the cache refreshed), and the
    port's table back into a fresh JAX one, bit for bit."""
    p, j = _twins(80, 3, 2, "adam", name="conv_t")
    rows = np.arange(0, 80, 5)
    j.pull(rows)
    j.push(rows, np.full((rows.size, 3), 0.25, np.float32), 0.1)
    svc = HostPSEmbedding(p, cache_slots=8, device=CPU)
    svc.pull(rows[:4])                              # cache the old rows
    assert convert.table_from_snapshot(convert.table_snapshot(j), svc) \
        == rows.size
    _same_state(p, j)
    np.testing.assert_array_equal(_np(svc.pull(rows[:4])), j.pull(rows[:4]))
    back = jhostps.HostSparseTable(80, 3, optimizer=jhostps.HostAdam(),
                                   seed=9, name="conv_t")
    convert.table_from_snapshot(convert.table_snapshot(svc), back)
    _same_state(p, back)
    with pytest.raises(ValueError, match="snapshot is"):
        convert.table_from_snapshot(convert.table_snapshot(j),
                                    HostSparseTable(81, 3))


# -- DeepFM over HostPS (tools/deepfm_hostps.py) -----------------------------

def _jax_deepfm_step(dense, lr, D):
    from paddle_tpu.models import deepfm as jdeepfm

    @jax.jit
    def step(values, inv, dense, label):
        def loss_fn(values, dense):
            v = values[inv]
            e, lin = v[..., :D], v[..., D]
            p = dict(dense, w_linear=None, embed=None)
            logits = jdeepfm._deepfm_head(p, e, lin)
            y = label.astype(jnp.float32)
            return jnp.mean(jnp.maximum(logits, 0) - logits * y
                            + jnp.log1p(jnp.exp(-jnp.abs(logits))))
        loss, (g_vals, g_dense) = jax.value_and_grad(
            loss_fn, argnums=(0, 1))(values, dense)
        dense = jax.tree.map(lambda p, g: p - lr * g, dense, g_dense)
        return loss, g_vals, dense

    return step


def test_deepfm_hostps_step_matches_jax_and_routes_agree():
    """The bench's step at a tiny width: the port's ``"host"`` route against
    the JAX step on the same table and dense head (losses at rtol 1e-5,
    prefetch one batch ahead on the port), and the ``"merge"`` route held to
    the ``"host"`` route: from one state, the same loss bit for bit and each
    table's touched rows within the derived bound of the float64 update."""
    from paddle_tpu.models import deepfm as jdeepfm

    vocab, B, F, D, mlp, lr, steps = 5000, 32, 6, 4, (16, 8), 0.05, 4
    rng = np.random.RandomState(0)
    batches = [dh.zipf_ids(rng, B, F, vocab) for _ in range(steps)]
    cfg = jdeepfm.DeepFMConfig(num_features=2, num_fields=F, embed_dim=D,
                               mlp_dims=mlp)
    jp = jdeepfm.init_deepfm_params(jax.random.PRNGKey(0), cfg)
    jdense = {"mlp": jp["mlp"], "bias": jp["bias"]}
    dense = convert.params_from_numpy(
        jax.tree.map(np.asarray, jdense), CPU)
    svc = dh.make_embedding(vocab, D, 64, device=CPU, name="dfm_p")
    jsvc = jhostps.HostPSEmbedding(
        jhostps.HostSparseTable(vocab, D + 1, optimizer=jhostps.HostSGD(),
                                seed=0, name="dfm_j"), cache_slots=64)
    jstep = _jax_deepfm_step(jdense, lr, D)
    pl, jl = [], []
    for k, ids in enumerate(batches):
        nxt = batches[k + 1] if k + 1 < steps else None
        loss, dense = dh.train_step(svc, dense, ids, dh.labels(ids), lr,
                                    "host", next_ids=nxt)
        pl.append(float(loss))
        rows, values, inv = jsvc.pull_unique(ids)
        l, g_vals, jdense = jstep(values, jnp.asarray(inv), jdense,
                                  jnp.asarray(dh.labels(ids)))
        jsvc.push(rows, np.asarray(g_vals[:rows.shape[0]]), lr)
        jl.append(float(l))
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert prof.counters().get("hostps.prefetch.hit") == steps - 1
    touched = np.unique(np.concatenate(batches))
    np.testing.assert_allclose(svc.table.pull(touched),
                               jsvc.table.pull(touched), rtol=1e-5,
                               atol=1e-6)

    # the two routes, each step from one state
    a = dh.make_embedding(vocab, D, 64, device=CPU, name="route_host")
    b = dh.make_embedding(vocab, D, 64, device=CPU, name="route_merge")
    dense = convert.params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    dense = {"mlp": dense["mlp"], "bias": dense["bias"]}
    for ids in batches:
        flat = ids.reshape(-1)
        table0 = _RowView(dict(zip(np.unique(flat).tolist(),
                                   b.table.pull(np.unique(flat)))))
        ra, rb = {}, {}
        la, _ = dh.train_step(a, dense, ids, dh.labels(ids), lr, "host",
                              record=ra)
        lb, dense = dh.train_step(b, dense, ids, dh.labels(ids), lr, "merge",
                                  record=rb)
        assert float(la) == float(lb)
        assert torch.equal(ra["occ_grads"], rb["occ_grads"])
        uniq, ref, bound = fp_bounds.host_sgd_update(
            table0, lr, flat, rb["occ_grads"].numpy(), vocab)
        for t in (a, b):
            r, _ = fp_bounds.ratio(t.table.pull(uniq), ref, bound)
            assert r <= 1.0, r
        # resynchronise: the host twin adopts the merge twin's rows
        convert.table_from_snapshot(convert.table_snapshot(b), a)


class _RowView:
    """Rows of a {row: values} dict indexed by an id array."""

    def __init__(self, rows):
        self.rows = rows

    def __getitem__(self, ids):
        return np.stack([self.rows[int(r)] for r in ids])


# -- stress (excluded from tier-1) -------------------------------------------

@pytest.mark.slow
def test_multi_gib_host_table_stress():
    """A ~2 GiB-virtual table (64M x 8 f32) only materializes the touched
    pages: pulls/pushes at the extremes of the id space stay correct and
    rows_initialized stays tiny."""
    vocab = 64 * 1024 * 1024
    t = HostSparseTable(vocab, 8, optimizer=HostAdagrad(), seed=11)
    assert t.nbytes_virtual > 2 * 1024 ** 3
    rng = np.random.RandomState(0)
    ids = np.concatenate([
        rng.randint(0, 1000, 500),
        rng.randint(vocab - 1000, vocab, 500),
        rng.randint(0, vocab, 1000),
    ])
    v1 = t.pull(ids)
    v2 = t.pull(ids)
    np.testing.assert_array_equal(v1, v2)
    rows = np.unique(ids)
    t.push(rows, np.ones((rows.size, 8), np.float32), 0.1)
    v3 = t.pull(rows)
    assert not np.allclose(v3, t.initializer(rows))
    assert t.rows_initialized <= 2000
