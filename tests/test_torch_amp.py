"""Fluid mixed precision in the port (``amp.py`` and the executor's AMP
branch) against the JAX package on the CPU.

``amp.decorate(optimizer).minimize(loss)`` tags the program; the executor
then casts float32 params and feeds to bfloat16 at the forward's boundary
(integer ids and labels stay as they are), sums the loss in f32, so the
gradients come back f32 for the f32 masters, and runs the optimizer on the
f32 masters, moments and LR state; state the forward wrote (the batch
norm's running stats) comes back f32.

Tolerances: both sides compute the forward in bf16 on the CPU, where XLA
may keep an f32 intermediate inside a fusion that eager PyTorch rounds to
bf16, so their results part by a few bf16 roundings (2^-8 relative each):
the loss to ``BF16_LOSS_TOL`` 2e-2 and each gradient to ``BF16_GRAD_TOL``
5e-2 of the largest magnitude of any gradient of the step (the rounding
follows the activations' scale: a bias before a batch norm has a true
gradient of 0 and a bf16 one of rounding noise); the parameters after one
step, which move by
about lr wherever |g| is well above epsilon, to lr / 4 absolute where the
gradients' signs agree.  The AMP loss against the f32 program's first loss
to ``BF16_LOSS_TOL`` too.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu import amp as jamp
from paddle_tpu.models import book as jbook
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import book as pbook

BF16_LOSS_TOL, BF16_GRAD_TOL = 2e-2, 5e-2
LR = 1e-2


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mlp_bn(fluid, amp, use_amp=True):
    """fc -> batch_norm -> relu -> fc -> softmax, cross entropy, Adam;
    decorated by ``amp`` unless ``use_amp`` is false."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[12], dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        h = fluid.layers.batch_norm(fluid.layers.fc(x, 16), act="relu")
        pred = fluid.layers.fc(h, 4, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, y))
        opt = fluid.optimizer.Adam(LR)
        (amp.decorate(opt) if use_amp else opt).minimize(loss)
    return main, startup, loss


def word2vec_amp(fluid, amp, is_sparse):
    """The book's word2vec (softmax head) under AMP, its ids int64."""
    book = pbook if fluid is pfluid else jbook
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ws = [fluid.layers.data("w%d" % i, shape=[1], dtype="int64")
              for i in range(4)]
        nxt = fluid.layers.data("nxt", shape=[1], dtype="int64")
        _, loss = book.build_word2vec(ws, nxt, 50, embed_size=8,
                                      hidden_size=16, is_sparse=is_sparse)
        amp.decorate(fluid.optimizer.Adam(LR)).minimize(loss)
    return main, startup, loss


def mlp_feed(seed=0, B=32):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, 12).astype("f4")
    return {"x": x, "y": (x[:, :4].argmax(1)).reshape(-1, 1).astype("int64")}


def w2v_feed(seed=0, B=24):
    ids = np.random.RandomState(seed).randint(0, 50, (B, 5)).astype("int64")
    feed = {("w%d" % i): ids[:, i:i + 1] for i in range(4)}
    feed["nxt"] = ids[:, 4:5]
    return feed


def start_both(builder, *args):
    """Both packages' programs, the JAX startup run and its values in a
    port scope: ((exe, scope, main, loss) for JAX, then for the port)."""
    jmain, jstart, jloss = builder(jfluid, jamp, *args)
    pmain, pstart, ploss = builder(pfluid, pamp, *args)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    names = [v.name for v in jstart.list_vars() if v.persistable]
    pscope = convert.scope_from_numpy(convert.scope_to_numpy(jscope, names),
                                      pfluid.Scope(), "cpu")
    return ((jexe, jscope, jmain, jloss),
            (pfluid.Executor(pfluid.CPUPlace()), pscope, pmain, ploss))


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- the API ---------------------------------------------------------------------

def test_decorate_tags_the_program_and_wraps_the_optimizer():
    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.program_guard(main, startup):
        x = pfluid.layers.data("x", shape=[3], dtype="float32")
        loss = pfluid.layers.mean(pfluid.layers.fc(x, 2))
        sgd = pfluid.optimizer.SGD(0.1)
        lists = pamp.AutoMixedPrecisionLists(custom_white_list=["mul"],
                                             custom_black_list=["softmax"])
        opt = pamp.decorate(sgd, amp_lists=lists, init_loss_scaling=8.0)
        assert isinstance(opt, pamp.OptimizerWithMixedPrecision)
        assert opt.get_loss_scaling() == 8.0
        assert opt._learning_rate == sgd._learning_rate    # passes through
        assert getattr(main, "_amp", None) is None
        opt.minimize(loss)
    assert main._amp == {"enabled": True, "dtype": "bfloat16"}
    assert lists.white_list == {"mul"} and lists.black_list == {"softmax"}
    assert pamp.CustomOpLists is pamp.AutoMixedPrecisionLists
    mp = pfluid.contrib.mixed_precision
    assert mp.decorate is pamp.decorate
    assert pfluid.amp_guard is pamp.amp_guard


def test_amp_guard_tags_the_default_program_and_restores_it():
    main = pfluid.Program()
    with pfluid.program_guard(main):
        with pamp.amp_guard():
            assert main._amp == {"enabled": True, "dtype": "bfloat16"}
            with pamp.amp_guard(enable=False):
                assert main._amp["enabled"] is False
            assert main._amp["enabled"] is True
        assert main._amp is None


def test_a_program_without_the_tag_runs_in_f32():
    """The same program built without ``decorate``: every fetched
    intermediate is f32, as before."""
    (_, _, _, _), (pexe, pscope, pmain, ploss) = start_both(mlp_bn, False)
    pred = [op.outputs["Out"][0] for op in pmain.global_block().ops
            if op.type == "softmax"][0]
    out = pexe.run(pmain, feed=mlp_feed(), fetch_list=[ploss, pred],
                   scope=pscope, return_numpy=False)
    assert all(t.dtype == torch.float32 for t in out)


# -- one AMP step against JAX's ---------------------------------------------------

def test_one_amp_step_matches_jax():
    (jexe, jscope, jmain, jloss), (pexe, pscope, pmain, ploss) = \
        start_both(mlp_bn)
    params = [p.name for p in pmain.all_parameters()]
    pred = [op.outputs["Out"][0] for op in pmain.global_block().ops
            if op.type == "softmax"][0]
    fetch = [ploss.name, pred] + [p + "@GRAD" for p in params]
    before = convert.scope_to_numpy(pscope, params)
    jout = jexe.run(jmain, feed=mlp_feed(), fetch_list=fetch, scope=jscope)
    pout = pexe.run(pmain, feed=mlp_feed(), fetch_list=fetch, scope=pscope,
                    return_numpy=False)
    assert pout[1].dtype == torch.bfloat16           # the forward ran in bf16
    assert all(g.dtype == torch.float32 for g in pout[2:])
    pout = [t.float().numpy() for t in pout]
    assert rel(pout[0], jout[0]) <= BF16_LOSS_TOL, (pout[0], jout[0])
    g_scale = max(np.abs(j).max() for j in jout[2:])
    for name, j, p in zip(params, jout[2:], pout[2:]):
        err = np.abs(p.astype(np.float64) - j).max()
        assert err <= BF16_GRAD_TOL * g_scale, (name, err, g_scale)
        same_sign = np.sign(p) == np.sign(j)
        moved_j = jscope.find_tensor_as_numpy(name) - before[name]
        moved_p = pscope.find_tensor_as_numpy(name) - before[name]
        assert (np.abs(moved_p - moved_j)[same_sign] <= LR / 4).all(), name


def test_the_amp_loss_is_the_f32_loss_within_bf16():
    (_, _, _, _), (pexe, pscope, pmain, ploss) = start_both(mlp_bn)
    (_, _, _, _), (fexe, fscope, fmain, floss) = start_both(mlp_bn, False)
    (la,) = pexe.run(pmain, feed=mlp_feed(), fetch_list=[ploss], scope=pscope)
    (lf,) = fexe.run(fmain, feed=mlp_feed(), fetch_list=[floss], scope=fscope)
    assert rel(la, lf) <= BF16_LOSS_TOL, (la, lf)


@pytest.mark.parametrize("is_sparse", [False, True])
def test_word2vec_amp_step_matches_jax_with_int64_ids(is_sparse):
    """Integer ids go through uncast (the lookup would refuse bf16 ids);
    with ``is_sparse`` the table's rows leaf is cast like a parameter."""
    (jexe, jscope, jmain, jloss), (pexe, pscope, pmain, ploss) = \
        start_both(word2vec_amp, is_sparse)
    for step in range(2):
        (jl,) = jexe.run(jmain, feed=w2v_feed(step), fetch_list=[jloss],
                         scope=jscope)
        (pl,) = pexe.run(pmain, feed=w2v_feed(step), fetch_list=[ploss],
                         scope=pscope)
        assert rel(pl, jl) <= BF16_LOSS_TOL, (step, pl, jl)
    w = pscope.find_var("shared_w")
    assert w.dtype == torch.float32
    # two Adam steps at lr 1e-2 move a row by up to 2e-2; the two sides'
    # tables stay within a few bf16 roundings of each other
    assert rel(w.numpy(), jscope.find_tensor_as_numpy("shared_w")) <= 1e-2


# -- the f32-master and BN-stat contract --------------------------------------------

def test_after_amp_steps_every_state_var_is_f32():
    """Masters, Adam's moments and beta powers, the LR var and the batch
    norm's running stats: f32 in the scope after AMP steps, and the running
    stats moved."""
    (_, _, _, _), (pexe, pscope, pmain, ploss) = start_both(mlp_bn)
    state = [v.name for v in pmain.list_vars() if v.persistable]
    stats = [n for n in state if "batch_norm" in n and
             (n.endswith(".mean_0") or n.endswith(".var_0")
              or "mean" in n or "variance" in n)]
    assert stats
    start = convert.scope_to_numpy(pscope, stats)
    for step in range(3):
        pexe.run(pmain, feed=mlp_feed(step), fetch_list=[ploss], scope=pscope)
    kinds = set()
    for n in state:
        t = pscope.find_var(n)
        assert t.dtype == torch.float32, (n, t.dtype)
        kinds.update(k for k in ("moment", "beta1_pow", "learning_rate",
                                 "batch_norm", ".w_0") if k in n)
    assert kinds == {"moment", "beta1_pow", "learning_rate", "batch_norm",
                     ".w_0"}, kinds
    for n in stats:
        assert not np.array_equal(pscope.find_tensor_as_numpy(n), start[n]), n


# -- bf16 persistables across the packages ---------------------------------------------

def test_bf16_persistables_cross_the_packages_after_amp_steps(tmp_path):
    """An AMP program with a bf16 persistable beside its f32 state: saved by
    the port after a step, loaded by the JAX package bit for bit; saved by
    the JAX package, loaded by the port as torch.bfloat16."""
    import jax.numpy as jnp

    (jexe, jscope, jmain, jloss), (pexe, pscope, pmain, ploss) = \
        start_both(mlp_bn)
    bits = np.array([0x3F80, 0xC000, 0x3DCD], np.uint16)
    for prog in (jmain, pmain):
        prog.global_block().create_var(name="ema_bf16", shape=(3,),
                                       dtype="bfloat16", persistable=True)
    pscope.var("ema_bf16")
    pscope.set("ema_bf16", torch.from_numpy(bits.view(np.int16).copy())
               .view(torch.bfloat16))
    pexe.run(pmain, feed=mlp_feed(), fetch_list=[ploss], scope=pscope)
    with pfluid.scope_guard(pscope):
        pfluid.io.save_persistables(pexe, str(tmp_path / "port"), pmain)
    loaded = jfluid.Scope()
    with jfluid.scope_guard(loaded):
        jfluid.io.load_persistables(jexe, str(tmp_path / "port"), jmain)
    np.testing.assert_array_equal(
        np.asarray(loaded.find_var("ema_bf16")).view(np.uint16), bits)
    for p in pmain.all_parameters():
        np.testing.assert_array_equal(np.asarray(loaded.find_var(p.name)),
                                      pscope.find_tensor_as_numpy(p.name))

    jscope.var("ema_bf16")
    jscope.set("ema_bf16", jnp.asarray(bits.view(np.int16)).view(jnp.bfloat16))
    with jfluid.scope_guard(jscope):
        jfluid.io.save_persistables(jexe, str(tmp_path / "jax"), jmain)
    back = pfluid.Scope()
    with pfluid.scope_guard(back):
        pfluid.io.load_persistables(pexe, str(tmp_path / "jax"), pmain)
    t = back.find_var("ema_bf16")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                  bits)
