"""The serving engine over captured CUDA graphs on the card: every lattice
point captured at start (with its memory ledger), zero captures while
serving, and a version swap that never tears a replay in flight.  Every
test needs a card and skips without one; this file imports neither JAX nor
the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serving_cuda.py

The smoke model of ``tools/serve_bench.py`` (x[12] + a looked-up emb[16]
-> fc 16 ReLU -> fc 1) stands in for a model.  Tolerance: against the
CPU's exported module on the same rows, the bound ``BoundMode`` derives
from the program's ops (``serve_bench.program_bounds``); a request served
alone against ``ExportedPredictor.run`` at the same bucket bit for bit (the
same graph)."""

import threading

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.inference import load_exported_model
from paddle_tpu_torch.serving import BucketLattice, ServeEngine
from paddle_tpu_torch.tools import serve_bench


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
        pytest.skip("needs a CUDA card (CUDA graphs have no CPU route)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def served(cuda_device, tmp_path):
    """(artifact dir, lookup, read-only table) on the card."""
    d = serve_bench.build_artifact(fluid, str(tmp_path / "m"),
                                   np.random.RandomState(0),
                                   device=cuda_device)
    table, _emb, lookup = serve_bench.make_lookup(512, 4, 64,
                                                  device=cuda_device)
    return d, lookup, table


def _engine(d, lookup, mode, name):
    return ServeEngine(load_exported_model(d), BucketLattice([2, 4, 8]),
                       feed_spec=serve_bench.SMOKE_FEED_SPEC,
                       lookups=[lookup], mode=mode, name=name)


def test_lattice_captured_with_ledgers_and_no_capture_while_serving(served):
    d, lookup, table = served
    rng = np.random.RandomState(1)
    trace = serve_bench.request_trace(20, 32, rng, 512)
    eng = _engine(d, lookup, "continuous", "cuda_serve")
    with eng:
        assert eng.precompile_sources["compiled"] == 3
        for b in (2, 4, 8):
            led = eng.predictor.signature_ledger(eng._point_shapes(b, None))
            assert led["output_bytes"] > 0 and led["temp_bytes"] >= 0
        assert eng._need_bytes >= 8 * 28 * 4
        futs = [eng.submit(dict(t)) for t in trace]
        outs = [f.result(timeout=120)[0] for f in futs]
    s = eng.last_summary
    assert s["recompiles"] == 0 and s["new_compiled_sigs"] == 0
    assert s["completed"] == 20 and table.rows_initialized == 0
    loaded = serve_bench._load_program(d)
    for t, got in zip(trace, outs):
        feed = lookup(dict(t))
        (ref, bound), = serve_bench.program_bounds(d, feed, _loaded=loaded)
        assert serve_bench._hold(got, ref, bound)["ok"]


def test_request_alone_equals_the_predictor_at_its_bucket(served):
    d, lookup, _table = served
    rng = np.random.RandomState(2)
    trace = [t for t in serve_bench.request_trace(10, 8, rng, 512)]
    eng = _engine(d, lookup, "static", "cuda_static")
    with eng:
        outs = [eng.submit(dict(t)).result(timeout=120)[0] for t in trace]
    ref = load_exported_model(d)
    ref.declare_batch_buckets([2, 4, 8])
    for t, got in zip(trace, outs):
        (want,) = ref.run(lookup(dict(t)))
        np.testing.assert_array_equal(got, want)


def test_swap_under_load_never_tears_a_replay(served):
    """Requests keep arriving while the weights flip back and forth between
    two versions: every output equals, bit for bit, what the request gives
    alone on one of the two versions — never a mix."""
    d, lookup, _table = served
    eng = _engine(d, lookup, "static", "cuda_swap")
    ep = eng.predictor
    v0 = {n: t.clone() for n, t in ep._state.items()}
    v1 = {n: t * -1.5 for n, t in v0.items()}
    rng = np.random.RandomState(3)
    probe = serve_bench.request_trace(1, 8, rng, 512)[0]
    probe = {k: v[:1] for k, v in probe.items()}
    outs, stop = [], threading.Event()
    with eng:
        def client():
            while not stop.is_set():
                outs.append(eng.submit(dict(probe)).result(timeout=60)[0])

        t = threading.Thread(target=client)
        t.start()
        for k in range(10):
            eng.request_swap(lambda k=k: ep.swap_state(v1 if k % 2 == 0
                                                       else v0) and None,
                             version=k + 1, timeout=60)
        stop.set()
        t.join()
    want = []
    for state in (v0, v1):
        ref = load_exported_model(d)
        ref.declare_batch_buckets([2, 4, 8])
        ref.swap_state(state)
        want.append(ref.run(lookup(dict(probe)))[0])
    assert not np.array_equal(want[0], want[1])
    assert outs and all(np.array_equal(o, want[0]) or np.array_equal(o, want[1])
                        for o in outs)
    assert eng.last_summary["recompiles"] == 0
    assert eng.last_summary["new_compiled_sigs"] == 0


def test_a_two_replica_fleet_serves_the_predictors_bits(cuda_device,
                                                        tmp_path):
    """Two replica processes on the card (``FleetManager``, ``--device
    cuda``) behind a ``FleetRouter``, their rows from a ShardPS owner
    process through ``FleetCTRView``: each request sent alone is served in
    one step, bit for bit ``ExportedPredictor.run`` at its bucket in this
    process on a twin table's rows; every lattice point captured by each
    replica, none while serving; the owner's table never written."""
    from paddle_tpu_torch.serving import FleetManager, FleetRouter

    d = serve_bench.build_artifact(fluid, str(tmp_path / "m"),
                                   np.random.RandomState(0),
                                   device=cuda_device)
    ps, fw = str(tmp_path / "ps"), str(tmp_path / "fw")
    owner = serve_bench.start_owner(ps, "smoke", 512, 4)
    twin = serve_bench.owner_table("smoke", 512, 4)
    mgr = FleetManager(fw, d, str(tmp_path / "mon"),
                       ["x:12:float32", "emb:16:float32"], buckets="2,4,8",
                       device="cuda", ctr={"wire_dir": ps, "world": 1,
                                           "vocab": 512, "dim": 4})
    try:
        for rid in (0, 1):
            mgr.spawn(rid)
        mgr.wait_ready([0, 1], timeout=300)
        router = FleetRouter(fw, replicas=[0, 1], deadline=30.0,
                             poll=0.002).connect(timeout=60)
        ref = load_exported_model(d, device=cuda_device)
        ref.declare_batch_buckets([2, 4, 8])
        rng = np.random.RandomState(3)
        for rows in (1, 2, 3, 4, 5, 8, 2, 7):
            feed = {"x": rng.rand(rows, 12).astype("f4"),
                    "ids": rng.randint(0, 512, (rows, 4)).astype("i8")}
            (got,) = router.submit(dict(feed))
            emb = twin.pull(feed["ids"], materialize=False).reshape(rows, -1)
            (want,) = ref.run({"x": feed["x"], "emb": emb})
            assert got.tobytes() == np.asarray(want).tobytes()
        for rid in (0, 1):
            st = router.stats(rid)
            assert st["precompile_sources"]["compiled"] == 3
            assert st["recompiles"] == 0 and st["new_compiled_sigs"] == 0
            assert router.retire(rid)["replica"] == rid
            assert mgr.wait(rid, timeout=60) == 0
        rec = serve_bench.stop_owner(ps, owner)
        owner = None
        assert rec["rows_initialized"] == 0 and rec["rc"] == 0
    finally:
        mgr.stop_all(timeout=30)
        if owner is not None:
            owner.kill()
