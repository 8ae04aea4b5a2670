"""Fluid programs with sub-blocks, built on whichever ``fluid`` the caller
passes (``paddle_tpu_torch``, or the JAX package in the parity tests), so
that ``chip_smoke.py`` and the tests build the same programs:

- ``while_beam_decode``: the program-mode beam decode of the JAX package's
  ``tests/test_rnn_beam_ops.py:213`` — a ``While`` loop over T steps
  driving the ``beam_search`` op, the step tokens and parents written into
  [T, B, K] accumulators through one-hot masks, then
  ``beam_search_decode``.  The per-step probabilities are fed whole,
  [T, B, K, V], and read by the loop body as a closure (not a carried
  var);
- ``cond_program``: a ``cond`` in a trained forward section, each branch
  with its own fc layer, trained by SGD;
- ``switch_program``: an LR-warmup style ``Switch`` with overlapping
  cases (the JAX package's Switch: the last matching case wins).

Each returns ``(main, startup, vars)``, built under a fresh
``unique_name.guard()`` so the two packages name every var alike.
"""

__all__ = ["while_beam_decode", "cond_program", "switch_program"]


def while_beam_decode(fluid, T, B, K, V, end_id=0):
    """Feeds: "lp" [T, B, K, V] f32 probabilities, "ps" [B, K] f32 initial
    scores, "pi" [B, K] int32 initial ids.  vars["sent"]: [B, K, T] int32
    sentences, best first."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        layers = fluid.layers
        lp = layers.data("lp", shape=[T, B, K, V], dtype="float32",
                         append_batch_size=False)
        ps = layers.data("ps", shape=[B, K], dtype="float32",
                         append_batch_size=False)
        pi = layers.data("pi", shape=[B, K], dtype="int32",
                         append_batch_size=False)
        blk = main.global_block()
        ids_arr = layers.fill_constant([T, B, K], "int32", 0)
        par_arr = layers.fill_constant([T, B, K], "int32", 0)
        t_var = layers.fill_constant([1], "int32", 0)
        tmax = layers.fill_constant([1], "int32", T)
        cond = layers.less_than(t_var, tmax)
        w = layers.While(cond)
        with w.block():
            lp_t = layers.reshape(layers.gather(lp, t_var), [B, K, V])
            sub = main.current_block()
            si = sub.create_var(name="bs_si", shape=(B, K), dtype="int32")
            ss = sub.create_var(name="bs_ss", shape=(B, K), dtype="float32")
            pa = sub.create_var(name="bs_pa", shape=(B, K), dtype="int32")
            sub.append_op(
                type="beam_search",
                inputs={"pre_scores": [ps.name], "scores": [lp_t.name],
                        "pre_ids": [pi.name]},
                outputs={"selected_ids": [si.name],
                         "selected_scores": [ss.name],
                         "parent_idx": [pa.name]},
                attrs={"beam_size": K, "end_id": end_id,
                       "is_accumulated": False})
            oh = layers.reshape(layers.one_hot(t_var, T), [T, 1, 1])
            keep = layers.cast(layers.scale(oh, scale=-1.0, bias=1.0), "int32")
            put = layers.cast(oh, "int32")
            layers.assign(ids_arr * keep + put * layers.reshape(si, [1, B, K]),
                          ids_arr)
            layers.assign(par_arr * keep + put * layers.reshape(pa, [1, B, K]),
                          par_arr)
            layers.assign(ss, ps)
            layers.assign(si, pi)
            layers.assign(layers.elementwise_add(
                t_var, layers.fill_constant([1], "int32", 1)), t_var)
            layers.assign(layers.less_than(t_var, tmax), cond)
        sent = blk.create_var(name="bs_sent", shape=(B, K, T), dtype="int32")
        blk.append_op(
            type="beam_search_decode",
            inputs={"Ids": [ids_arr.name], "ParentIdx": [par_arr.name]},
            outputs={"SentenceIds": [sent.name]})
    return main, startup, {"lp": lp, "ps": ps, "pi": pi, "sent": sent}


def cond_program(fluid, width=8, hidden=6, out=3, lr=0.1):
    """x [N, width] -> h = fc(x, hidden, tanh); pred = mean(h) < 0;
    r = cond(pred, fc_true(h), fc_false(h * 2)); loss = mean(r * r); SGD.
    Which branch a batch takes depends on its data."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        layers = fluid.layers
        x = layers.data("x", shape=[width], dtype="float32")
        h = layers.fc(x, hidden, act="tanh")
        zero = layers.fill_constant([1], "float32", 0.0)
        pred = layers.less_than(layers.mean(h), zero)
        r = layers.cond(pred, lambda: layers.fc(h, out),
                        lambda: layers.fc(layers.scale(h, 2.0), out))
        loss = layers.mean(layers.elementwise_mul(r, r))
        fluid.optimizer.SGD(lr).minimize(loss)
    return main, startup, {"x": x, "h": h, "pred": pred, "r": r,
                           "loss": loss}


def switch_program(fluid):
    """step [1] f32 -> lr through a Switch of overlapping cases: step < 5
    gives 0.1, step < 10 gives 0.2, the default 0.3.  The last matching
    case wins, so steps below 5 give 0.2 (Paddle's first match would give
    0.1)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        layers = fluid.layers
        step = layers.data("step", shape=[1], dtype="float32",
                           append_batch_size=False)
        lr = layers.create_global_var(shape=[1], value=0.0, dtype="float32",
                                      persistable=True, name="switch_lr")
        consts = [layers.fill_constant([1], "float32", v)
                  for v in (0.1, 0.2, 0.3, 5.0, 10.0)]
        with layers.Switch() as switch:
            with switch.case(layers.less_than(step, consts[3])):
                layers.assign(consts[0], lr)
            with switch.case(layers.less_than(step, consts[4])):
                layers.assign(consts[1], lr)
            with switch.default():
                layers.assign(consts[2], lr)
    return main, startup, {"step": step, "lr": lr}
