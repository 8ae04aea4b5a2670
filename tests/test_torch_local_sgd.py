"""Local SGD (ROADMAP item 5-C′, ``parallel/local_sgd.py``) held to the JAX
package.

A gloo world of 4 ranks (``tests/torch_sharded_worker.py``) runs
``tests/test_flags_and_degradation.py``'s two Local SGD tests on the port,
each rank holding its own replica; while it runs, the JAX package runs
them with its stacked [dp, ...] replicas over a dp = 4 mesh of the
simulated CPU devices, from the same parameters and batches (carried as
numpy).  The port's replicas are gathered into the reference's stacked
layout to compare:

- ``local_steps = 1`` with SGD equals sync data parallelism (the port's
  ``make_train_step`` and the JAX run) at the reference's atol / rtol 1e-5;
- ``local_steps = 3``: the replicas differ after steps 1, 2, 4 and 5 and
  are equal bit for bit after steps 3 and 6, the losses (each the mean over
  the replicas) and the stacked replicas match the JAX run's at rtol 1e-5
  and atol 1e-6, and the model learns.

The fleet knob ``use_local_sgd`` warns, with the reference's wording, that
program mode runs sync data parallelism and points at the functional
engine.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

import torch_dp_worker as W
import torch_sharded_worker as SW

WORLD = 4
SCENARIOS = ["local_sgd_k1", "local_sgd_k3"]


def _mlp_loss(params, batch):
    h = jnp.maximum(batch["x"] @ params["w1"] + params["b1"], 0)
    pred = h @ params["w2"] + params["b2"]
    return jnp.mean(jnp.square(pred - batch["y"]).astype(jnp.float32))


def _mlp_params(key):
    k1, k2 = jax.random.split(key)
    return {"w1": jax.random.normal(k1, (8, 16), jnp.float32) * 0.3,
            "b1": jnp.zeros((16,), jnp.float32),
            "w2": jax.random.normal(k2, (16, 1), jnp.float32) * 0.3,
            "b2": jnp.zeros((1,), jnp.float32)}


def _mlp_batch(rng, n=32):
    x = rng.rand(n, 8).astype("f4")
    return {"x": x, "y": (x @ rng.rand(8, 1).astype("f4")).astype("f4")}


def _jax_runs(batches):
    """The reference tests' runs: sync DP and Local SGD at k = 1 (four
    steps), Local SGD at k = 3 (six steps), with the stacked replicas after
    every step."""
    from paddle_tpu.parallel import MeshSpec, optim
    from paddle_tpu.parallel import collectives as col
    from paddle_tpu.parallel.local_sgd import (make_local_sgd_train_step,
                                               stack_local_state)
    from paddle_tpu.parallel.mesh import DP
    from paddle_tpu.parallel.train import (TrainState, make_train_step,
                                           shard_pytree, state_specs)

    mesh = MeshSpec(dp=WORLD).build()
    pspecs = jax.tree.map(lambda _: JP(), _mlp_params(jax.random.PRNGKey(0)))
    syncs = jax.tree.map(lambda _: (DP,), pspecs,
                         is_leaf=lambda x: isinstance(x, JP))
    bspecs = {"x": JP(DP), "y": JP(DP)}
    opt = optim.sgd()

    def dp_loss(params, b):
        local = jnp.sum(jnp.square((jnp.maximum(
            b["x"] @ params["w1"] + params["b1"], 0) @ params["w2"]
            + params["b2"]) - b["y"]).astype(jnp.float32))
        cnt = col.psum(jnp.float32(b["x"].shape[0]), DP)
        return col.global_mean_loss(local, cnt, DP)

    out = {}
    state = TrainState.create(_mlp_params(jax.random.PRNGKey(0)), opt)
    with mesh:
        state = shard_pytree(state, state_specs(pspecs, state), mesh)
    step = make_train_step(dp_loss, mesh, pspecs, syncs, opt, bspecs)(state)
    ref = []
    for _ in range(4):
        state, l = step(state, batches[1], 0.1)
        ref.append(float(l))
    out["sync_dp"] = {"losses": ref, "params": jax.tree.map(
        np.asarray, state["params"])}
    for k, steps in ((1, 4), (3, 6)):
        build = make_local_sgd_train_step(_mlp_loss, mesh, pspecs, syncs, opt,
                                          bspecs, local_steps=k)
        st = stack_local_state(TrainState.create(
            _mlp_params(jax.random.PRNGKey(0)), opt), WORLD)
        step_fn, lspecs = build(st)
        with mesh:
            st = shard_pytree(st, lspecs, mesh)
        losses, stacks = [], []
        for _ in range(steps):
            st, l = step_fn(st, batches[k], 0.1)
            losses.append(float(l))
            stacks.append(jax.tree.map(np.asarray, st["params"]))
        out[k] = {"losses": losses, "stacks": stacks, "specs": lspecs}
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    params = jax.tree.map(np.asarray, _mlp_params(jax.random.PRNGKey(0)))
    batches = {1: _mlp_batch(np.random.RandomState(1)),
               3: _mlp_batch(np.random.RandomState(2))}
    tmp = tmp_path_factory.mktemp("local_sgd")
    out, procs = W.spawn_world(tmp, WORLD, {"local_sgd": {
        "params": params, "batches": batches}}, SCENARIOS,
        script=SW.__file__)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = _jax_runs(batches)
    finally:
        got = W.join_world(out, procs, SCENARIOS)
    return got, ref


def _close(got, want, **tol):
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **tol)


def test_local_sgd_k1_equals_sync_dp(world):
    """With plain SGD and local_steps = 1, Local SGD is sync DP up to
    rounding: averaging after a linear update equals updating with the
    mean gradient."""
    got, ref = world
    for res in got["local_sgd_k1"]:
        np.testing.assert_allclose(res["losses"], res["sync_dp"]["losses"],
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(res["losses"], ref["sync_dp"]["losses"],
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(res["losses"], ref[1]["losses"],
                                   atol=1e-5, rtol=1e-5)
        for r in range(WORLD):
            _close({n: s[r] for n, s in res["stacks"][-1].items()},
                   res["sync_dp"]["params"], atol=1e-5, rtol=1e-5)
        _close(res["stacks"][-1], ref[1]["stacks"][-1], atol=1e-5, rtol=1e-5)


def test_local_sgd_k3_replicas_diverge_then_sync(world):
    got, ref = world
    res = got["local_sgd_k3"]
    for r in res[1:]:           # every rank gathered the same stack
        for s, s0 in zip(r["stacks"], res[0]["stacks"]):
            assert all(s[n].tobytes() == s0[n].tobytes() for n in s)
    res = res[0]
    assert res["step"] == 6
    for i, stack in enumerate(res["stacks"], 1):
        w1 = stack["w1"]                        # [dp, 8, 16]
        same = all(np.array_equal(w1[0], w1[j]) for j in range(1, WORLD))
        if i % 3 == 0:
            assert same, "replicas must be equal right after a sync step"
        else:
            assert not same, "replicas must diverge between syncs"
        _close(stack, ref[3]["stacks"][i - 1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res["losses"], ref[3]["losses"], rtol=1e-5,
                               atol=1e-6)
    assert res["losses"][-1] < res["losses"][0]      # still learning
    # the stacked layout's specs are the reference's
    specs = res["specs"]
    assert tuple(specs["params"]["w1"]) == tuple(ref[3]["specs"]["params"][
        "w1"]) == ("dp",)
    assert tuple(specs["step"]) == ()


def test_fleet_use_local_sgd_warns_with_the_reference_wording():
    import paddle_tpu_torch as pfluid
    from paddle_tpu_torch.distributed import fleet as pfleet

    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.unique_name.guard(), pfluid.program_guard(main, startup):
        x = pfluid.layers.data("x", shape=[4], dtype="float32")
        loss = pfluid.layers.mean(pfluid.layers.fc(x, size=1))
        strategy = pfleet.DistributedStrategy()
        strategy.use_local_sgd = True
        opt = pfleet._Fleet().distributed_optimizer(
            pfluid.optimizer.SGD(0.1), strategy)
        pfleet.DistributedOptimizer._warned_local_sgd = False
        with warnings.catch_warnings(record=True) as said:
            warnings.simplefilter("always")
            opt.minimize(loss)
    texts = [str(w.message) for w in said]
    assert any("runs synchronous DP" in t and "parallel/local_sgd.py "
               "make_local_sgd_train_step" in t for t in texts), texts
    assert not any("waits" in t for t in texts)
