"""The row-sharded embedding tables and sharded DeepFM (ROADMAP item 5-C′)
held to the JAX package.

One gloo world of 2 ranks and one of 4 (``tests/torch_sharded_worker.py``,
started once for the module) run ``tests/test_sparse.py``'s
``test_sharded_embedding_parity`` and ``test_deepfm_sharded_embedding_
parity`` on the port, each rank holding its row block of the tables and
its rows of the batch; while they run, the JAX package runs the same
functions in ``shard_map`` over the 8 simulated CPU devices of
``tests/conftest.py`` and the dense one-device model, from the same
tables, parameters and batch (carried as numpy).  Tolerances are the
reference test's: the lookup at rtol 1e-6, its gradient at rtol 1e-5 and
atol 1e-6, DeepFM's loss at rtol 1e-5 and its gradients at rtol 1e-4 and
atol 1e-6.  The sharded trainer (``build_deepfm_trainer(mesh=...)``, the
segment variant's SGD with the MLP psum'd) is held to the port's one-rank
segment trainer over three steps at rtol 1e-5 and atol 1e-6.

In this process: the capacity guard raising its "host-RAM
parameter-server" error, ``init_embedding_table`` under
``use_host_sparse_table`` returning a ``HostPSEmbedding`` whose rows are
the JAX route's bit for bit, the budget read from a configured limit (and, with none on a host without a card, a request for
one rather than a guessed size), and the fleet knob setting the flag.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from paddle_tpu.models import deepfm as jdeepfm
from paddle_tpu.parallel import collectives as jcol
from paddle_tpu.parallel import (embedding_spec as jembedding_spec,
                                 init_sharded_table as jinit_sharded_table,
                                 sharded_embedding_lookup as jlookup)
from paddle_tpu.parallel.mesh import local_shard_map, make_mesh as jmake_mesh
from paddle_tpu_torch.models import deepfm as pdeepfm
from paddle_tpu_torch.parallel import embedding as pemb

import torch_dp_worker as W
import torch_sharded_worker as SW


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SCENARIOS = ["sharded_lookup", "deepfm_sharded", "deepfm_trainer"]
N_JAX = 8


def _jax_lookup():
    """``test_sharded_embedding_parity``'s JAX side: the table, the ids,
    the lookup over the 8-device mesh and its gradient."""
    mesh = jmake_mesh(dp=N_JAX)
    vocab, dim = 64, 16
    table = jinit_sharded_table(jax.random.PRNGKey(0), vocab, dim, N_JAX)
    ids = jnp.asarray(np.random.RandomState(0).randint(0, vocab, (4, 5)))
    f = jax.jit(local_shard_map(
        lambda t, i: jlookup(t, i, "dp"), mesh,
        in_specs=(jembedding_spec("dp"), JP()), out_specs=JP()))

    def loss_sharded(t, i):
        y = jlookup(t, i, "dp")
        return jcol.psum(jnp.sum(y * y), "dp") / N_JAX

    g = jax.jit(jax.grad(local_shard_map(
        loss_sharded, mesh, in_specs=(jembedding_spec("dp"), JP()),
        out_specs=JP())))(table, ids)
    g_ref = jax.grad(lambda t: jnp.sum(t[ids] ** 2))(table)
    return ({"table": np.asarray(table), "ids": np.asarray(ids)},
            {"y": np.asarray(f(table, ids)), "grad": np.asarray(g),
             "grad_dense": np.asarray(g_ref)})


def _jax_deepfm():
    """``test_deepfm_sharded_embedding_parity``'s JAX side: the sharded
    loss and gradients over the 8-device mesh and the dense model's."""
    mesh = jmake_mesh(dp=N_JAX)
    cfg_kw = {"num_features": 64 * N_JAX}
    cfg = jdeepfm.deepfm_tiny_config(**cfg_kw)
    params = jdeepfm.init_deepfm_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.RandomState(0)
    batch = {"feat_ids": rng.randint(0, cfg.num_features,
                                     (16, cfg.num_fields)).astype(np.int32),
             "label": rng.randint(0, 2, (16,)).astype(np.float32)}
    loss_ref, g_ref = jax.value_and_grad(
        lambda p: jdeepfm.deepfm_loss(p, batch, cfg))(params)
    specs = jdeepfm.deepfm_param_specs(cfg, "dp")

    def step(p, b):
        l, g = jax.value_and_grad(
            lambda p_: jdeepfm.deepfm_loss_sharded(p_, b, cfg, "dp"))(p)
        g["mlp"] = jax.tree.map(lambda a: jcol.psum(a, "dp"), g["mlp"])
        g["bias"] = jcol.psum(g["bias"], "dp")
        return l, g

    f = jax.jit(local_shard_map(
        step, mesh, in_specs=(specs, {"feat_ids": JP("dp"),
                                      "label": JP("dp")}),
        out_specs=(JP(), specs)))
    loss_sh, g_sh = f(params, batch)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    brng = np.random.RandomState(5)
    batches = [{"feat_ids": brng.randint(0, cfg.num_features,
                                         (16, cfg.num_fields)).astype(np.int32),
                "label": brng.randint(0, 2, (16,)).astype(np.float32)}
               for _ in range(3)]
    return ({"cfg": cfg_kw, "params": np_tree(params), "batch": batch,
             "batches": batches, "lr": 0.5},
            {"loss": float(loss_sh), "grads": np_tree(g_sh),
             "loss_dense": float(loss_ref), "grads_dense": np_tree(g_ref)})


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lookup_in, lookup_ref = _jax_lookup()
        deepfm_in, deepfm_ref = _jax_deepfm()
    inputs = {"lookup": lookup_in, "deepfm": deepfm_in}
    tmp = tmp_path_factory.mktemp("sharded_embedding")
    runs = [W.spawn_world(tmp, world, inputs, SCENARIOS, script=SW.__file__)
            for world in (2, 4)]
    got = {world: W.join_world(out, procs, SCENARIOS)
           for world, (out, procs) in zip((2, 4), runs)}
    return got, {"lookup": lookup_ref, "deepfm": deepfm_ref}, inputs


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_embedding_parity(worlds, world):
    """The row-sharded lookup equals the plain gather, and its gradient the
    JAX shard_map's (and the dense gather's)."""
    got, ref, inputs = worlds
    want = ref["lookup"]
    table, ids = inputs["lookup"]["table"], inputs["lookup"]["ids"]
    for r, res in enumerate(got[world]["sharded_lookup"]):
        assert res["shard_rows"] == (64 // world, 16)
        np.testing.assert_allclose(res["y"], table[ids], rtol=1e-6)
        np.testing.assert_allclose(res["y"], want["y"], rtol=1e-6)
        np.testing.assert_allclose(res["grad"], want["grad"], rtol=1e-5,
                                   atol=1e-6, err_msg="rank %d" % r)
        np.testing.assert_allclose(res["grad"], want["grad_dense"],
                                   rtol=1e-5, atol=1e-6)


def _leaves(tree):
    return jax.tree.leaves(tree)


@pytest.mark.parametrize("world", [2, 4])
def test_deepfm_sharded_embedding_parity(worlds, world):
    """Row-sharded tables and a batch-sharded feed: the loss and the
    gradients match the JAX shard_map's and the dense one-device model's
    (the CTR configuration's pserver -> all-reduce parity, BASELINE
    config 5)."""
    got, ref, _ = worlds
    want = ref["deepfm"]
    for res in got[world]["deepfm_sharded"]:
        assert res["embed_rows"] == (64 * N_JAX // world, 4)
        np.testing.assert_allclose(res["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(res["loss"], want["loss_dense"],
                                   rtol=1e-5)
        for dense in (want["grads"], want["grads_dense"]):
            np.testing.assert_allclose(res["grads"]["embed"], dense["embed"],
                                       rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(res["grads"]["w_linear"],
                                       dense["w_linear"], rtol=1e-4,
                                       atol=1e-6)
            for a, b in zip(_leaves(res["grads"]["mlp"]),
                            _leaves(dense["mlp"])):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_deepfm_trainer_matches_the_one_rank_trainer(worlds, world):
    """Three SGD steps of ``build_deepfm_trainer(mesh=...)`` (tables
    row-sharded, the MLP psum'd) against the port's one-rank segment
    trainer on the same global batches."""
    got, _, inputs = worlds
    case = inputs["deepfm"]
    cfg = pdeepfm.deepfm_tiny_config(**case["cfg"])
    tr = pdeepfm.build_deepfm_trainer(cfg, device="cpu",
                                      params=case["params"])
    losses = [float(tr.step({k: torch.from_numpy(v) for k, v in b.items()},
                            case["lr"])) for b in case["batches"]]
    want = jax.tree.map(lambda t: t.numpy(), tr.state["params"])
    res = got[world]["deepfm_trainer"]
    for r in res:
        assert r["embed_rows"] == (64 * N_JAX // world, 4)
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5, atol=1e-6)
        for a, b in zip(_leaves(r["params"]), _leaves(want)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    for r in res[1:]:
        for a, b in zip(_leaves(r["params"]), _leaves(res[0]["params"])):
            assert a.tobytes() == b.tobytes()


# -- the capacity guard, in this process ------------------------------------------

@pytest.fixture
def budget():
    from paddle_tpu_torch.monitor import memscope

    pemb.configure_hbm_budget(1 << 20)
    yield
    pemb._HBM_BYTES_PER_CHIP = None
    pemb._HBM_TABLE_FRACTION = 0.6
    pemb.enable_host_sparse_table(False)
    memscope.reset()


def test_capacity_guard_names_the_host_parameter_server(budget):
    """A table past the mesh's aggregate budget raises before it is made,
    naming the host-RAM parameter-server route and its knob."""
    gen = torch.Generator().manual_seed(0)
    assert pemb.table_fits(1000, 16, 1)         # 64 KB of 600 KB
    t = pemb.init_sharded_table(gen, 1001, 16, 4, device="cpu")
    assert t.shape == (1004, 16)                 # padded to a multiple of 4
    with pytest.raises(ValueError, match="host-RAM parameter-server") as e:
        pemb.init_sharded_table(gen, 100000, 16, 2, device="cpu")
    assert "use_host_sparse_table" in str(e.value)
    assert "paddle_tpu_torch.hostps" in str(e.value)
    assert "HostPSEmbedding" in str(e.value)
    with pytest.raises(ValueError, match="host-RAM parameter-server"):
        pemb.init_embedding_table(gen, 100000, 16, 2, device="cpu")
    # a table that fits routes to the sharded table
    t = pemb.init_embedding_table(gen, 64, 16, 2, device="cpu")
    assert t.shape == (64, 16)


def test_host_sparse_table_route_waits_for_item_7(budget):
    """With the knob on, a table past the budget is a ``HostPSEmbedding``
    with the knob's cache; its rows are the JAX route's for the same seed
    (``manual_seed(s)`` against ``PRNGKey(s)``), bit for bit."""
    from paddle_tpu.hostps import HostPSEmbedding as JHostPSEmbedding
    from paddle_tpu.parallel import embedding as jemb
    from paddle_tpu_torch.hostps import HostPSEmbedding, HostSGD

    gen = torch.Generator().manual_seed(7)
    pemb.enable_host_sparse_table(True, cache_slots=128)
    assert pemb.host_sparse_table_enabled()
    h = pemb.init_embedding_table(gen, 100000, 16, 2, device="cpu",
                                  host_optimizer=HostSGD())
    assert isinstance(h, HostPSEmbedding)
    assert (h.vocab_size, h.dim, h.cache.num_slots) == (100000, 16, 128)
    old = (jemb._HBM_BYTES_PER_CHIP, jemb._HBM_TABLE_FRACTION,
           jemb.host_sparse_table_enabled())
    jemb.configure_hbm_budget(1 << 20)
    jemb.enable_host_sparse_table(True)
    try:
        j = jemb.init_embedding_table(jax.random.PRNGKey(7), 100000, 16,
                                      n_shards=2)
    finally:
        jemb._HBM_BYTES_PER_CHIP, jemb._HBM_TABLE_FRACTION = old[:2]
        jemb.enable_host_sparse_table(old[2])
    assert isinstance(j, JHostPSEmbedding)
    ids = np.array([0, 5, 99999, 31337, 5])
    np.testing.assert_array_equal(h.pull(ids, use_cache=False).numpy(),
                                  np.asarray(j.pull(ids, use_cache=False)))
    # an explicit seed overrides the generator's
    h2 = pemb.init_embedding_table(None, 100000, 16, 2, device="cpu",
                                   host_seed=7, name="seeded")
    np.testing.assert_array_equal(h2.table.pull(ids), h.table.pull(ids))


def test_budget_is_the_configured_limit_never_a_guess():
    """With no card and nothing configured the guard asks for a budget; a
    memscope limit (or ``configure_hbm_budget``) is what it reads."""
    from paddle_tpu_torch.monitor import memscope

    assert not torch.cuda.is_available()
    memscope.reset()
    try:
        with pytest.raises(ValueError, match="configure_hbm_budget"):
            pemb.table_fits(10, 4)
        memscope.configure(bytes_limit=1000)
        assert pemb._hbm_bytes_per_chip() == 1000
        assert pemb.table_fits(10, 4)            # 160 B of 600 B
        assert not pemb.table_fits(100, 4)       # 1600 B
        pemb.configure_hbm_budget(10 ** 6, table_fraction=0.5)
        assert pemb._hbm_bytes_per_chip() == 10 ** 6
    finally:
        pemb._HBM_BYTES_PER_CHIP = None
        pemb._HBM_TABLE_FRACTION = 0.6
        memscope.reset()


def test_fleet_use_host_sparse_table_sets_the_flag():
    import paddle_tpu_torch as pfluid
    from paddle_tpu_torch.distributed import fleet as pfleet

    strategy = pfleet.DistributedStrategy()
    strategy.use_host_sparse_table = True
    strategy.host_sparse_cache_slots = 64
    try:
        pfleet._Fleet().distributed_optimizer(pfluid.optimizer.SGD(0.1),
                                              strategy)
        assert pemb.host_sparse_table_enabled()
        assert pemb._HOST_SPARSE_CACHE_SLOTS == 64
        # the newest strategy decides
        pfleet._Fleet().distributed_optimizer(
            pfluid.optimizer.SGD(0.1), pfleet.DistributedStrategy())
        assert not pemb.host_sparse_table_enabled()
    finally:
        pemb.enable_host_sparse_table(False, cache_slots=0)


def test_embedding_module_keeps_the_reference_names():
    from paddle_tpu.parallel import embedding as jemb

    assert pemb.__all__ == jemb.__all__
    import paddle_tpu_torch.parallel as pparallel

    for name in ("sharded_embedding_lookup", "init_sharded_table",
                 "init_embedding_table", "embedding_spec", "local_sgd"):
        assert hasattr(pparallel, name), name
