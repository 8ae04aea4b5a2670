"""RNN layers (parity: layers/rnn.py + layers/control_flow.py StaticRNN /
DynamicRNN and operators/gru_op.cc, lstm_op.cc, attention_lstm).

Design translation: the reference's StaticRNN/DynamicRNN run a sub-block per
timestep through recurrent_op / while_op with LoD rank tables; here the
time loop is a `scan` op (the port's rule runs the step block once per
time step), with sequence lengths handled by masking.  A copy of the JAX
package's ``layers/rnn.py``.
"""

import numpy as np

from ..layer_helper import LayerHelper
from ..framework import default_main_program
from ..initializer import ConstantInitializer
from . import tensor as T
from . import nn

__all__ = ["StaticRNN", "DynamicRNN", "lstm_unit", "gru_unit", "dynamic_lstm", "dynamic_gru", "scan_block"]


class StaticRNN:
    """Parity: layers/control_flow.py StaticRNN — step-function RNN over a
    fixed sequence length, captured into a scan sub-block.

    with rnn.step():
        x_t = rnn.step_input(x)          # x: [N, T, D] (batch-major)
        h = rnn.memory(init=h0)          # carried state
        h_new = some_layers(x_t, h)
        rnn.update_memory(h, h_new)
        rnn.step_output(h_new)
    outs = rnn()                          # [N, T, H]
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self.program = default_main_program()
        self._xs = []  # (outer var, inner var)
        self._mems = []  # (inner mem var, init var, updated inner var name)
        self._outputs = []
        self._sub_block = None
        self._built = False

    def step(self):
        return _StaticRNNGuard(self)

    def step_input(self, x):
        # x: [N, T, ...] -> per-step [N, ...]
        inner = self._sub_block.create_var(
            name=self.helper.name + ".x%d" % len(self._xs),
            shape=(x.shape[0],) + tuple(x.shape[2:]),
            dtype=x.dtype,
        )
        self._xs.append((x, inner))
        return inner

    def memory(self, init=None, shape=None, batch_ref=None, init_value=0.0, dtype="float32"):
        if init is None:
            # the init var must be computed OUTSIDE the step sub-block (it is
            # the scan op's Carry input); memory() is called inside the
            # block guard, so temporarily rewind to the parent
            cur_idx = self.program.current_block_idx
            self.program._rollback()
            try:
                if batch_ref is not None:
                    init = T.fill_constant_batch_size_like(
                        batch_ref, [1] + list(shape), dtype, init_value)
                else:
                    init = T.fill_constant(shape, dtype, init_value)
            finally:
                self.program.current_block_idx = cur_idx
        inner = self._sub_block.create_var(
            name=self.helper.name + ".mem%d" % len(self._mems),
            shape=init.shape,
            dtype=init.dtype,
        )
        self._mems.append([inner, init, None])
        return inner

    def update_memory(self, mem, new):
        for m in self._mems:
            if m[0] is mem or m[0].name == mem.name:
                m[2] = new.name
                return
        raise ValueError("update_memory: unknown memory %r" % mem.name)

    def step_output(self, o):
        self._outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def __call__(self):
        if not self._built:
            raise RuntimeError("StaticRNN used before its step block closed")
        return self._result[0] if len(self._result) == 1 else self._result


class _StaticRNNGuard:
    def __init__(self, rnn):
        self.rnn = rnn

    def __enter__(self):
        self.rnn._sub_block = self.rnn.program._create_block()
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is not None:
            return False
        rnn = self.rnn
        program = rnn.program
        sub = rnn._sub_block
        program._rollback()
        parent = program.current_block()
        helper = rnn.helper

        # transpose step inputs to time-major for lax.scan
        xs_outer = []
        xs_inner_names = []
        for x, inner in rnn._xs:
            perm = [1, 0] + list(range(2, len(x.shape)))
            xt = nn.transpose(x, perm)
            xs_outer.append(xt)
            xs_inner_names.append(inner.name)

        carry_names = []
        carry_inits = []
        # map carried names: the scan body env uses the inner mem name; the
        # body must end with the updated value bound to the same name, so
        # append an assign inside the sub-block
        for inner, init, updated in rnn._mems:
            if updated is None:
                raise RuntimeError("memory %r never updated" % inner.name)
            sub.append_op(type="assign", inputs={"X": [updated]}, outputs={"Out": [inner.name]})
            carry_names.append(inner.name)
            carry_inits.append(init)

        ys_names = [o.name for o in rnn._outputs]
        t = rnn._xs[0][0].shape[1] if rnn._xs else None
        carry_outs = [
            helper.create_variable_for_type_inference(v.dtype, v.shape) for v in carry_inits
        ]
        ys_outs = [
            helper.create_variable_for_type_inference(
                o.dtype, (t,) + tuple(o.shape))
            for o in rnn._outputs
        ]
        parent.append_op(
            type="scan",
            inputs={"Carry": carry_inits, "Xs": xs_outer},
            outputs={"CarryOut": carry_outs, "Ys": ys_outs},
            attrs={
                "sub_block_index": sub.idx,
                "carry_names": carry_names,
                "xs_names": xs_inner_names,
                "ys_names": ys_names,
            },
        )
        # back to batch-major
        rnn._result = []
        for y in ys_outs:
            perm = [1, 0] + list(range(2, len(y.shape)))
            rnn._result.append(nn.transpose(y, perm))
        rnn._built = True
        return False


def scan_block(carry_inits, xs, body_builder, name=None):
    """Generic scan layer: body_builder(carry_vars, x_vars) -> (new_carries, ys).
    The microbatch/time loop primitive (used by pipeline parallel)."""
    helper = LayerHelper("scan", name=name)
    program = default_main_program()
    sub = program._create_block()
    carry_vars = [
        sub.create_var(name=helper.name + ".c%d" % i, shape=c.shape, dtype=c.dtype)
        for i, c in enumerate(carry_inits)
    ]
    x_vars = [
        sub.create_var(name=helper.name + ".x%d" % i,
                       shape=tuple(x.shape[1:]), dtype=x.dtype)
        for i, x in enumerate(xs)
    ]
    new_carries, ys = body_builder(carry_vars, x_vars)
    for cv, nc in zip(carry_vars, new_carries):
        sub.append_op(type="assign", inputs={"X": [nc]}, outputs={"Out": [cv.name]})
    program._rollback()
    parent = program.current_block()
    t = xs[0].shape[0] if xs else None
    carry_outs = [helper.create_variable_for_type_inference(c.dtype, c.shape) for c in carry_inits]
    ys_outs = [helper.create_variable_for_type_inference(y.dtype, (t,) + tuple(y.shape))
               for y in ys]
    parent.append_op(
        type="scan",
        inputs={"Carry": list(carry_inits), "Xs": list(xs)},
        outputs={"CarryOut": carry_outs, "Ys": ys_outs},
        attrs={
            "sub_block_index": sub.idx,
            "carry_names": [c.name for c in carry_vars],
            "xs_names": [x.name for x in x_vars],
            "ys_names": [y.name for y in ys],
        },
    )
    return carry_outs, ys_outs


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0, param_attr=None,
              bias_attr=None, name=None):
    """Parity: layers/nn.py lstm_unit — one LSTM step as fc + activations."""
    concat_in = T.concat([x_t, hidden_t_prev], axis=1)
    hidden = hidden_t_prev.shape[1]
    gates = nn.fc(concat_in, size=4 * hidden, param_attr=param_attr, bias_attr=bias_attr,
                  name=name)
    i, f, c, o = nn.split(gates, 4, dim=1)
    from . import math_ops as M

    i = M.sigmoid(i)
    f = M.sigmoid(f + forget_bias if forget_bias else f)
    c_bar = M.tanh(c)
    o = M.sigmoid(o)
    new_cell = f * cell_t_prev + i * c_bar
    new_hidden = o * M.tanh(new_cell)
    return new_hidden, new_cell


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid", name=None):
    """Parity: layers/nn.py gru_unit."""
    from . import math_ops as M

    d = size // 3
    gates = nn.fc(T.concat([input, hidden], axis=1), size=2 * d,
                  param_attr=param_attr, bias_attr=bias_attr, name=(name or "gru") + "_gates")
    u, r = nn.split(gates, 2, dim=1)
    u = M.sigmoid(u)
    r = M.sigmoid(r)
    c = nn.fc(T.concat([input, r * hidden], axis=1), size=d,
              param_attr=param_attr, bias_attr=bias_attr, name=(name or "gru") + "_cand",
              act=activation)
    new_hidden = u * hidden + (u * (-1.0) + 1.0) * c
    return new_hidden, [u, r], c


def _time_reverse(x, seq_len=None):
    """Reverse the time axis of a padded [N, T, D] tensor (per-sequence when
    seq_len is given, whole axis otherwise) via the sequence_reverse op."""
    from .sequence import sequence_reverse

    return sequence_reverse(x, seq_len=seq_len)


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None, bias_attr=None,
                 use_peepholes=False, is_reverse=False, gate_activation="sigmoid",
                 cell_activation="tanh", candidate_activation="tanh", name=None,
                 seq_len=None):
    """LSTM over a full padded sequence [N, T, 4*hidden projected input].
    Reference dynamic_lstm consumes LoD input; here input is [N, T, D] and the
    recurrence runs under scan (masking by caller if needed).  is_reverse runs
    the recurrence back-to-front (ref lstm_op.cc is_reverse): the input is
    time-reversed (per sequence when seq_len is given), scanned, and the
    outputs reversed back so output step t still aligns with input step t."""
    hidden = size // 4
    helper = LayerHelper(name or "dynamic_lstm")
    if is_reverse:
        input = _time_reverse(input, seq_len)
    rnn = StaticRNN(name=helper.name)
    with rnn.step():
        x_t = rnn.step_input(input)
        h = rnn.memory(batch_ref=input, shape=[hidden], dtype=input.dtype)
        c = rnn.memory(batch_ref=input, shape=[hidden], dtype=input.dtype)
        nh, nc = lstm_unit(x_t, h, c, param_attr=param_attr, bias_attr=bias_attr,
                           name=helper.name + "_unit")
        rnn.update_memory(h, nh)
        rnn.update_memory(c, nc)
        rnn.step_output(nh)
        rnn.step_output(nc)
    hs, cs = rnn()
    if is_reverse:
        hs = _time_reverse(hs, seq_len)
        cs = _time_reverse(cs, seq_len)
    return hs, cs


def dynamic_gru(input, size, param_attr=None, bias_attr=None, is_reverse=False,
                gate_activation="sigmoid", candidate_activation="tanh", h_0=None,
                name=None, seq_len=None):
    helper = LayerHelper(name or "dynamic_gru")
    if is_reverse:
        input = _time_reverse(input, seq_len)
    rnn = StaticRNN(name=helper.name)
    with rnn.step():
        x_t = rnn.step_input(input)
        h = rnn.memory(batch_ref=input, shape=[size], dtype=input.dtype)
        nh, _, _ = gru_unit(x_t, h, size * 3, param_attr=param_attr,
                            bias_attr=bias_attr, name=helper.name + "_unit")
        rnn.update_memory(h, nh)
        rnn.step_output(nh)
    out = rnn()
    if is_reverse:
        out = _time_reverse(out, seq_len)
    return out


class DynamicRNN(StaticRNN):
    """Parity: layers/control_flow.py DynamicRNN — variable-length RNN.

    The reference sorts LoD sequences into a rank table and shrinks the
    batch as short sequences finish (recurrent_op + DynamicRNN's memory
    shrinking).  Static-shape translation: padded [N, T, D] input plus a
    `lengths` [N] tensor; every update_memory is rewired through
    where(t < length, new, old) so finished rows freeze, and step outputs
    are zeroed past each row's length — identical math on a fixed shape.

    drnn = DynamicRNN(lengths=seq_len)
    with drnn.block():
        x_t = drnn.step_input(x)               # x: [N, T, D] padded
        h = drnn.memory(shape=[H], batch_ref=x)
        nh = some_layers(x_t, h)
        drnn.update_memory(h, nh)
        drnn.output(nh)
    outs = drnn()                               # [N, T, H], zero-padded
    """

    def __init__(self, lengths=None, name=None):
        super().__init__(name=name)
        if lengths is None:
            raise ValueError(
                "DynamicRNN needs the sequence-length tensor: "
                "DynamicRNN(lengths=...) — padded batches carry no LoD")
        self._lengths = lengths
        self._mask_inner = None

    def block(self):
        return self.step()

    def step_input(self, x, level=0):
        inner = super().step_input(x)
        if self._mask_inner is None:
            # [N, T, 1] validity mask fed as a regular step input; built
            # lazily so it lands OUTSIDE the sub-block
            from . import nn as _nn
            from .sequence import sequence_mask as _sm

            T_len = x.shape[1]
            cur_idx = self.program.current_block_idx
            self.program._rollback()
            try:
                mask = _sm(self._lengths, maxlen=T_len, dtype="float32")
                mask = _nn.unsqueeze(mask, axes=[2])
            finally:
                self.program.current_block_idx = cur_idx
            self._mask_outer = mask
            self._mask_inner = super().step_input(mask)
        return inner

    def update_memory(self, mem, new):
        from . import math_ops as M

        frozen = M.elementwise_add(
            M.elementwise_mul(new, self._mask_inner),
            M.elementwise_mul(mem, M.scale(self._mask_inner, scale=-1.0,
                                           bias=1.0)),
        )
        super().update_memory(mem, frozen)

    def output(self, *outputs):
        from . import math_ops as M

        for o in outputs:
            super().step_output(M.elementwise_mul(o, self._mask_inner))
