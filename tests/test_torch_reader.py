"""The port's py_reader programs and ``DataLoader.from_generator`` against
the JAX package's ``Executor`` on the CPU.

The book's LeNet (``models/lenet.py``) fed by ``layers.py_reader`` +
``read_file``, and the same LeNet fed through ``DataLoader.from_generator``,
train three SGD steps in both packages from the JAX startup's values on the
same seeded digits: every loss and every parameter after the steps to 1e-5
of the largest magnitude (f32).  A started reader raises ``EOFException``
after its last batch, ``reset`` and ``start`` rearm it, and the executor
runs a py_reader program (it refused one before the data path was ported).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu.models import lenet as jlenet
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import lenet as plenet

TOL, B, STEPS = 1e-5, 16, 3


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _digits(seed, n=B):
    rng = np.random.RandomState(seed)
    ys = rng.randint(0, 10, (n, 1)).astype("int64")
    xs = rng.rand(n, 1, 28, 28).astype("f4") * 0.1
    for i, k in enumerate(ys[:, 0]):
        xs[i, 0, :k + 2, :k + 2] += 1.0
    return xs, ys


def _batches():
    for k in range(STEPS):
        yield _digits(k)


def _build(fluid, feed):
    """LeNet + SGD(0.1), fed by a py_reader ("py_reader") or by data vars
    for a DataLoader ("loader"); returns (main, startup, loss, source)."""
    models = plenet if fluid is pfluid else jlenet
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if feed == "py_reader":
            src = fluid.layers.py_reader(
                capacity=4, shapes=[(-1, 1, 28, 28), (-1, 1)],
                dtypes=["float32", "int64"])
            img, label = fluid.layers.read_file(src)
        else:
            img = fluid.layers.data("img", shape=[1, 28, 28], dtype="float32")
            label = fluid.layers.data("label", shape=[1], dtype="int64")
            src = fluid.DataLoader.from_generator(feed_list=[img, label],
                                                  capacity=4)
        _, loss, _ = models.build_lenet(img, label)
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss, src


def _both(feed):
    jmain, jstart, jloss, jsrc = _build(jfluid, feed)
    pmain, pstart, ploss, psrc = _build(pfluid, feed)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    names = sorted(v.name for v in jstart.list_vars() if v.persistable)
    pscope = convert.scope_from_numpy(convert.scope_to_numpy(jscope, names),
                                      pfluid.Scope(), "cpu")
    pexe = pfluid.Executor(pfluid.CPUPlace())
    return ((jexe, jscope, jmain, jloss, jsrc),
            (pexe, pscope, pmain, ploss, psrc), names)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= TOL * max(np.abs(want).max(), 1e-30), (what, err)


def _run_py_reader(exe, scope, main, loss, **kw):
    losses = []
    while True:
        try:
            (lv,) = exe.run(main, fetch_list=[loss], scope=scope, **kw)
        except (jfluid.EOFException, pfluid.EOFException):
            break
        losses.append(float(np.asarray(lv)))
    return losses


def test_py_reader_lenet_trains_like_jax():
    (jexe, jscope, jmain, jloss, jsrc), (pexe, pscope, pmain, ploss, psrc), \
        names = _both("py_reader")
    jsrc.decorate_batch_generator(_batches)
    psrc.decorate_batch_generator(_batches, places=pfluid.CPUPlace())
    jsrc.start()
    psrc.start()
    jl = _run_py_reader(jexe, jscope, jmain, jloss)
    pl = _run_py_reader(pexe, pscope, pmain, ploss)
    assert len(pl) == len(jl) == STEPS
    _close(pl, jl, "losses")
    for n in names:
        _close(pscope.find_tensor_as_numpy(n), jscope.find_tensor_as_numpy(n), n)
    # a second epoch after reset/start, and the end again
    psrc.reset()
    psrc.start()
    assert len(_run_py_reader(pexe, pscope, pmain, ploss)) == STEPS


def test_py_reader_sample_lists_and_eof():
    pmain, pstart, ploss, psrc = _build(pfluid, "py_reader")

    def samples():
        for xs, ys in _batches():
            yield list(zip(xs, ys))

    psrc.decorate_sample_list_generator(samples, places=pfluid.CPUPlace())
    exe, scope = pfluid.Executor(pfluid.CPUPlace()), pfluid.Scope()
    exe.run(pstart, scope=scope)
    psrc.start()
    for _ in range(STEPS):
        exe.run(pmain, fetch_list=[ploss], scope=scope)
    with pytest.raises(pfluid.EOFException):
        exe.run(pmain, fetch_list=[ploss], scope=scope)
    # an explicit feed of every reader var bypasses the reader
    xs, ys = _digits(9)
    names = [v.name for v in psrc._vars]
    exe.run(pmain, feed=dict(zip(names, (xs, ys))), fetch_list=[ploss],
            scope=scope)


def test_dataloader_lenet_trains_like_jax():
    (jexe, jscope, jmain, jloss, jsrc), (pexe, pscope, pmain, ploss, psrc), \
        names = _both("loader")
    jsrc.set_batch_generator(_batches)
    psrc.set_batch_generator(_batches, places=pfluid.CPUPlace())
    jl = [float(np.asarray(jexe.run(jmain, feed=b, fetch_list=[jloss],
                                    scope=jscope)[0])) for b in jsrc]
    pl = [float(pexe.run(pmain, feed=b, fetch_list=[ploss],
                         scope=pscope)[0]) for b in psrc]
    assert len(pl) == len(jl) == STEPS
    _close(pl, jl, "losses")
    for n in names:
        _close(pscope.find_tensor_as_numpy(n), jscope.find_tensor_as_numpy(n), n)


def test_create_py_reader_by_data_reads_existing_vars():
    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.unique_name.guard(), pfluid.program_guard(main, startup):
        x = pfluid.layers.data("x", shape=[3], dtype="float32")
        rdr = pfluid.layers.create_py_reader_by_data(capacity=2, feed_list=[x])
        assert pfluid.layers.read_file(rdr) is x
        out = pfluid.layers.scale(x, 2.0)
    rdr.decorate_batch_generator(
        lambda: iter([(np.ones((2, 3), "f4"),)]), places=pfluid.CPUPlace())
    exe = pfluid.Executor(pfluid.CPUPlace())
    rdr.start()
    (got,) = exe.run(main, fetch_list=[out])
    np.testing.assert_array_equal(got, np.full((2, 3), 2.0, "f4"))
    with pytest.raises(pfluid.EOFException):
        exe.run(main, fetch_list=[out])
