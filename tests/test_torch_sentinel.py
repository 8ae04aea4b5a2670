"""The port's TrainSentinel (``paddle_tpu_torch/monitor/sentinel.py``)
against the JAX package's on the CPU: the health vector on the same grads
and parameters at 1e-6, the localizer and the divergence detectors' outputs,
and through the port's executor on a small MLP: ``nan_batch`` under
``halt``, ``skip_batch`` bit for bit against a clean run that never saw the
batch, sentinel-off and monitor-off bit for bit, ``quarantine``'s committed
debug checkpoint and its repro, and ``FLAGS_check_nan_inf``."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu.monitor import sentinel as jsent
from paddle_tpu_torch import monitor as pmon
from paddle_tpu_torch.ft import chaos
from paddle_tpu_torch.monitor import sentinel as psent


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    pmon.disable()
    pmon.default_registry().reset()
    chaos.disarm()
    yield
    pmon.disable()
    pmon.default_registry().reset()
    chaos.disarm()
    pfluid.flags.set_flags({"FLAGS_check_nan_inf": False})
    jfluid.set_flags({"FLAGS_check_nan_inf": False})


def _health_inputs(nan):
    rng = np.random.RandomState(0)
    grads = {"fc_0.w_0": rng.randn(8, 16), "fc_0.b_0": rng.randn(16),
             "fc_1.w_0": rng.randn(16, 4), "conv2d_0.w_0": rng.randn(4, 3, 3, 3)}
    old = {"fc_0.w_0": rng.randn(8, 16), "fc_1.w_0": rng.randn(16, 4),
           "fc_0.b_0": rng.randn(16), "conv2d_0.w_0": rng.randn(4, 3, 3, 3)}
    new = {k: v + rng.randn(*v.shape) * 1e-2 for k, v in old.items()}
    if nan:
        grads["fc_1.w_0"][2, 3] = np.nan
        grads["fc_0.b_0"][5] = np.inf
    f32 = lambda d: {k: np.asarray(v, np.float32) for k, v in d.items()}
    return np.float32(1.2345), f32(grads), f32(old), f32(new)


@pytest.mark.parametrize("nan", [False, True])
def test_traced_health_equals_the_jax_vector(nan):
    loss, grads, old, new = _health_inputs(nan)
    tj = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    tt = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    jvec, jnames = jsent.traced_health(jnp.asarray(loss), tj(grads), tj(old),
                                       tj(new))
    pvec, pnames = psent.traced_health(torch.tensor(loss), tt(grads), tt(old),
                                       tt(new))
    assert pnames == jnames == ["conv2d_0", "fc_0", "fc_1"]
    jvec, pvec = np.asarray(jvec, np.float64), pvec.numpy().astype(np.float64)
    assert pvec.shape == jvec.shape == (6 + 3,)
    assert np.array_equal(np.isnan(pvec), np.isnan(jvec))
    ok = ~np.isnan(jvec)
    np.testing.assert_allclose(pvec[ok], jvec[ok], rtol=1e-6, atol=0)
    if nan:
        assert pvec[psent.IDX_NONFINITE] == 2 and list(pvec[6:]) == [0, 1, 1]


def test_traced_guard_reverts_read_and_written_state():
    vec = torch.tensor([1.0, 1.0, 0.1, 1.0, 2.0, 0.0])
    old = {"w": torch.ones(3), "m": torch.zeros(2)}
    new = {"w": torch.full((3,), 2.0), "m": torch.ones(2), "out": torch.ones(1)}
    guarded, v2 = psent.traced_guard(vec, old, new)
    assert torch.equal(guarded["w"], old["w"]) and torch.equal(guarded["m"], old["m"])
    assert guarded["out"] is new["out"] and v2[psent.IDX_SKIPPED] == 1
    guarded, v3 = psent.traced_guard(torch.zeros(6), old, new)
    assert guarded["w"] is not old["w"] and torch.equal(guarded["w"], new["w"])
    assert v3[psent.IDX_SKIPPED] == 0


def test_localize_nonfinite_and_the_detectors_match_the_reference():
    rng = np.random.RandomState(3)
    arrays = [("a", rng.randn(4, 5).astype(np.float32)),
              ("b", rng.randn(7).astype(np.float32)),
              ("ids", np.arange(5, dtype=np.int64)),
              ("c", rng.randn(2, 3).astype(np.float32))]
    arrays[1][1][[2, 5]] = [np.nan, -np.inf]
    arrays[3][1][1, 0] = np.inf
    want = jsent.localize_nonfinite(arrays)
    got = psent.localize_nonfinite([(n, torch.from_numpy(a)) for n, a in arrays])
    assert got == want and [b["name"] for b in got] == ["b", "c"]
    series = list(rng.randn(80) * 0.01 + 1.0)
    series[40] = 30.0                                   # a loss spike
    for jd, pd in ((jsent.LossSpikeDetector(), psent.LossSpikeDetector()),
                   (jsent.GradExplodeDetector(), psent.GradExplodeDetector()),
                   (jsent.PlateauDetector(window=20), psent.PlateauDetector(window=20))):
        assert [pd.observe(v) for v in series] == [jd.observe(v) for v in series]


# -- through the executor ------------------------------------------------------

def _mlp():
    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.unique_name.guard(), pfluid.program_guard(main, startup):
        x = pfluid.layers.data("x", shape=[8], dtype="float32")
        y = pfluid.layers.data("y", shape=[1], dtype="float32")
        h = pfluid.layers.fc(x, 16, act="tanh")
        loss = pfluid.layers.mean(pfluid.layers.square_error_cost(
            pfluid.layers.fc(h, 1), y))
        pfluid.optimizer.Adam(1e-2).minimize(loss)
    return main, startup, loss


def _batches(n=6):
    rng = np.random.RandomState(5)
    out = []
    for _ in range(n):
        xs = rng.randn(16, 8).astype(np.float32)
        out.append({"x": xs, "y": xs[:, :1] * 0.5})
    return out


def _train(batches, setup=None):
    """The MLP from one seeded startup, trained on ``batches``; returns the
    final scope's persistables as numpy and the losses."""
    main, startup, loss = _mlp()
    exe = pfluid.Executor(pfluid.CPUPlace())
    scope = pfluid.Scope()
    torch.manual_seed(0)
    exe.run(startup, scope=scope)
    if setup is not None:
        setup()
    losses = [exe.run(main, feed=b, fetch_list=[loss], scope=scope)[0]
              for b in batches]
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    return {n: scope.find_tensor_as_numpy(n) for n in names}, losses


def _same_bits(a, b):
    assert a.keys() == b.keys()
    for n in a:
        assert a[n].tobytes() == b[n].tobytes(), n


def test_nan_batch_under_halt_raises_naming_the_tensor(tmp_path):
    def setup():
        pmon.enable(str(tmp_path))
        pmon.sentinel.enable(policy="halt", sample_every=1)
        chaos.arm("nan_batch", at=3)

    with pytest.raises(psent.NonFiniteError) as err:
        _train(_batches(5), setup)
    e = err.value
    assert e.step == 3 and e.first and e.first in str(e)   # startup is step 0
    assert os.path.exists(e.postmortem)
    with open(e.postmortem) as f:
        post = json.load(f)
    assert post["reason"] == "nonfinite"
    assert post["health"]["first_bad"] == e.first


def test_skip_batch_equals_a_clean_run_that_never_saw_the_batch(tmp_path):
    batches = _batches(6)
    mon = []

    def setup():
        mon.append(pmon.enable(str(tmp_path)))
        pmon.sentinel.enable(policy="skip_batch")
        chaos.arm("nan_batch", at=3)

    skipped, _ = _train(batches, setup)
    assert mon[0].registry.counter("monitor.health.skipped_batches").value == 1
    pmon.disable()
    chaos.disarm()
    clean, _ = _train(batches[:2] + batches[3:])
    _same_bits(skipped, clean)


def test_sentinel_off_and_on_are_bit_identical_to_monitor_off(tmp_path):
    batches = _batches(9)
    off, loss_off = _train(batches)
    watched, loss_watched = _train(
        batches, lambda: pmon.enable(str(tmp_path / "m")))
    pmon.disable()

    def with_sentinel():
        pmon.enable(str(tmp_path / "s"))
        pmon.sentinel.enable(policy="halt", sample_every=2)

    sentinel, loss_sentinel = _train(batches, with_sentinel)
    _same_bits(off, watched)
    _same_bits(off, sentinel)
    assert [l.tobytes() for l in loss_off] == [l.tobytes() for l in loss_watched] \
        == [l.tobytes() for l in loss_sentinel]


def test_quarantine_policy_commits_debug_ckpt(tmp_path):
    """``quarantine``: skip_batch semantics (training goes on, the NaN
    batch's update reverted) plus one committed ``ckpt-<step>-quarantine``
    holding the pre-step state and the poisoned feed — invisible to
    ``latest_checkpoint``, CRC-verifiable, and a repro: restored and run
    once, the step's loss is nonfinite again."""
    from paddle_tpu_torch.parallel import checkpoint as pc

    qdir = str(tmp_path / "q")
    mon = []

    def setup():
        mon.append(pmon.enable(str(tmp_path / "mon")))
        pmon.sentinel.enable(policy="quarantine", sample_every=1,
                             quarantine_dir=qdir)
        chaos.arm("nan_batch", at=3)

    batches = _batches(5)
    _train(batches, setup)                  # never raises
    reg = mon[0].registry
    assert reg.counter("monitor.health.quarantines").value == 1
    assert reg.counter("monitor.health.skipped_batches").value == 1
    pmon.disable()
    chaos.disarm()
    names = os.listdir(qdir)
    assert names == ["ckpt-3-quarantine"]   # startup is step 0
    qpath = os.path.join(qdir, names[0])
    assert os.path.exists(os.path.join(qpath, "COMMIT"))
    assert pc.latest_checkpoint(qdir) is None
    z = np.load(os.path.join(qpath, "shards-p0.npz"))
    feed_keys = [k for k in z.files if k.startswith("feed/")]
    assert feed_keys and any(np.isnan(z[k]).any() for k in feed_keys
                             if z[k].dtype.kind == "f")
    for k in z.files:
        if k.startswith("scope/") and z[k].dtype.kind == "f":
            assert np.isfinite(z[k]).all(), "%s not pre-step state" % k
    z.close()
    pc.verify_checkpoint_files(qpath)
    # the repro: the quarantined state and feed, one step, the NaN again
    main, startup, loss = _mlp()
    exe = pfluid.Executor(pfluid.CPUPlace())
    scope = pfluid.Scope()
    exe.run(startup, scope=scope)
    with open(os.path.join(qpath, "index-p0.json")) as f:
        leaves = json.load(f)["leaves"]
    target = {"scope": {}, "feed": {}, "meta": {"step": np.int64(0)}}
    for path, meta in leaves.items():
        head, _, name = path.partition("/")
        if head in ("scope", "feed"):
            target[head][name] = torch.zeros(meta["shape"],
                                             dtype=getattr(torch, meta["dtype"]))
    st, step = pc.restore_checkpoint(qpath, target)
    assert step == 3 and st["meta"]["step"] == 3
    for n, v in st["scope"].items():
        scope.var(n)
        scope.set(n, v)
    (got,) = exe.run(main, feed=st["feed"], fetch_list=[loss], scope=scope)
    assert not np.isfinite(got).all()


def _nan_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        h = fluid.layers.fc(x, 3)
        loss = fluid.layers.mean(h)
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def test_flags_check_nan_inf_names_the_tensor_as_jax_does():
    """Both executors raise naming the same variable (the first of the
    written state, in name order)."""
    feed = {"x": np.array([[1.0, np.nan, 0.0, 2.0]], np.float32)}
    msgs = []
    for fluid in (jfluid, pfluid):
        main, startup, loss = _nan_program(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        fluid.set_flags({"FLAGS_check_nan_inf": True})
        with pytest.raises(RuntimeError, match="FLAGS_check_nan_inf") as err:
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        fluid.set_flags({"FLAGS_check_nan_inf": False})
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]
    assert "fc_0.w_0" in msgs[1]
