"""A Fluid-layers BERT encoder (``tools/programs.py``
``bert_encoder_program``: fc projections, ``matmul`` attention with a mask
bias, ``layer_norm``, a gelu FFN, a vocabulary fc and
``softmax_with_cross_entropy``) built on the JAX package and on the port,
run through each package's ``Executor(CPUPlace())`` from the JAX
startup's parameters: 2 layers, hidden 32, 4 heads, S = 16, B = 2, vocab
64, dropout 0.  Before this slice the port's Executor refused the
program (no rule for ``matmul``, ``layer_norm`` or ``gelu``).

Tolerances, f32, relative to the largest magnitude of the JAX value: the
loss at each of 3 steps and every parameter after them to 1e-5, for SGD
and for Adam.  The key projection's bias is the exception: softmax does
not change when a constant is added along its axis, so that bias has a
gradient of exactly 0 and both sides keep it at 0 up to rounding noise,
where a relative comparison would compare the noise.  It is held to
1e-5 lr a step on each side: a parameter whose gradient is real moves by
about lr a step under Adam, and the noise moved it by under 1e-6 lr a
step.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.tools.programs import (EncoderConfig,
                                             bert_encoder_program, encoder_feed)

TOL, STEPS = 1e-5, 3
CFG = EncoderConfig(vocab=64, hidden=32, layers=2, heads=4, ffn=64, seq=16,
                    batch=2, dropout=0.0, lr=0.05, optimizer="sgd")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max(initial=0.0)
    scale = max(np.abs(want).max(initial=0.0), 1e-30)
    assert err <= TOL * scale, "%s: %.3g of %.3g" % (what, err, scale)


def test_the_programs_match_op_for_op():
    jmain, _, _ = bert_encoder_program(jfluid, CFG)
    pmain, _, _ = bert_encoder_program(pfluid, CFG)
    jb, pb = jmain.global_block(), pmain.global_block()
    assert [op.type for op in pb.ops] == [op.type for op in jb.ops]
    for jo, po in zip(jb.ops, pb.ops):
        assert (po.inputs, po.outputs, po.attrs) == (jo.inputs, jo.outputs, jo.attrs)
    types = {op.type for op in pb.ops}
    assert {"matmul", "layer_norm", "gelu", "stack"} <= types


@pytest.mark.parametrize("optimizer,lr", [("sgd", 0.05), ("adam", 1e-3)])
def test_losses_and_parameters_match_the_jax_package(optimizer, lr):
    cfg = CFG._replace(optimizer=optimizer, lr=lr)
    jmain, jstart, jvars = bert_encoder_program(jfluid, cfg)
    pmain, pstart, pvars = bert_encoder_program(pfluid, cfg)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    names = sorted(v.name for v in jstart.list_vars() if v.persistable)
    pscope = convert.scope_from_numpy(convert.scope_to_numpy(jscope, names),
                                      pfluid.Scope(), "cpu")
    pexe = pfluid.Executor(pfluid.CPUPlace())
    for step in range(STEPS):
        feed = encoder_feed(cfg, seed=step)
        (jl,) = jexe.run(jmain, feed=feed, fetch_list=[jvars["loss"]],
                         scope=jscope)
        (pl,) = pexe.run(pmain, feed=feed, fetch_list=[pvars["loss"]],
                         scope=pscope)
        _close(pl, jl, "loss at step %d" % step)
    params = [p.name for p in pmain.global_block().all_parameters()]
    assert len(params) == 4 + 16 * cfg.layers + 2
    jv = convert.scope_to_numpy(jscope, params)
    pv = convert.scope_to_numpy(pscope, params)
    for n in params:
        if n.endswith("_key_fc.b_0"):
            assert max(np.abs(pv[n]).max(), np.abs(jv[n]).max()) <= (
                1e-5 * lr * STEPS), n
        else:
            _close(pv[n], jv[n], n)


def test_a_steps_intermediates_die_with_the_run():
    """The rules' context (``ctx.env``) and its sub-block closure form a
    cycle: before this repair it kept every intermediate of a step alive
    until the cyclic collector ran, which at BERT-base, B = 16 in f32 ran
    the card out of memory on the second step."""
    import gc
    import weakref

    from paddle_tpu_torch import executor as pexecutor

    cfg = CFG._replace(dropout=0.1, optimizer="adam", lr=1e-3)
    main, startup, v = bert_encoder_program(pfluid, cfg)
    exe, scope = pfluid.Executor(pfluid.CPUPlace()), pfluid.Scope()
    exe.run(startup, scope=scope)
    seen = []
    run_calls = pexecutor._run_calls

    def spy(calls, env, ctx):
        run_calls(calls, env, ctx)
        seen.extend(weakref.ref(t) for t in env.values()
                    if isinstance(t, torch.Tensor) and t.numel() > 1000)

    gc.disable()
    try:
        pexecutor._run_calls = spy
        exe.run(main, feed=encoder_feed(cfg, 0), fetch_list=[v["loss"]],
                scope=scope)
        pexecutor._run_calls = run_calls
        assert seen and not [r for r in seen if r() is not None]
    finally:
        pexecutor._run_calls = run_calls
        gc.enable()
