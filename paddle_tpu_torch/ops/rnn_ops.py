"""Recurrent op rules: gru, lstm and lstmp (counterparts of the rules in
``paddle_tpu/ops/rnn_ops.py``; parity: operators/gru_op.cc, lstm_op.cc,
lstmp_op.cc).

The reference ops take LoD-packed sequences reordered by a rank table
(sequence2batch.h); here, as in the JAX rules, the batch is padded
[B, T, ...] with an optional SeqLen input.  The JAX rules' ``lax.scan``
is a loop over T inside the rule, as the port's ``scan`` rule runs
(``ops/control_flow_ops.py``).  A step past a row's length freezes its
carry (m new + (1 - m) old, as the JAX rules blend it) and emits zeros;
``is_reverse`` reverses each row's valid prefix only, so a reverse
recurrence starts from the row's own last step.

- gru: Input [B, T, 3D] is x W_x + b, projected before (gru_op.cc), Weight
  [D, 3D] packs [W_update | W_reset | W_candidate], H0 [B, D] optional.
  u = act_g(x_u + h W_u); r = act_g(x_r + h W_r); c = act_c(x_c + (r h) W_c);
  h' = (1 - u) h + u c, or u h + (1 - u) c with ``origin_mode``.
- lstm: Input [B, T, 4D] projected, Weight [D, 4D] packs
  [W_i | W_f | W_c | W_o], H0 / C0 [B, D] optional.  i, f, o = act_g(.);
  c~ = act_c(.) (``cell_activation``); c' = f c + i c~;
  h' = o act_h(c') (``candidate_activation``).
- lstmp: lstm whose recurrence sees the projection r = act_p(h ProjWeight)
  [B, P]; Weight is [P, 4D].
"""

import torch

from ..registry import register_op
from .common import out, take_steps, x

_ACTS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda v: v,
}


def _mask_t(seq_len, t, B, dtype):
    """[B, 1]: 1 where step t lies inside the row, 0 after (None: no
    SeqLen input, every step)."""
    if seq_len is None:
        return None
    return (t < seq_len.reshape(B)).to(dtype)[:, None]


def _reverse(xs, seq_len):
    """Time-reverse [B, T, ...]: each row's valid prefix only, with SeqLen
    (the padding stays at the tail); a length past T reads
    ``take_steps``' fill, as ``take_along_axis``.  An involution, so it
    also restores the outputs' order."""
    if seq_len is None:
        return torch.flip(xs, dims=(1,))
    B, T = xs.shape[0], xs.shape[1]
    t = torch.arange(T, device=xs.device)[None, :]
    ln = seq_len.reshape(B, 1).long()
    return take_steps(xs, torch.where(t < ln, ln - 1 - t, t))


def _valid_steps(seq_len, B, T, dtype, device):
    return (torch.arange(T, device=device)[None, :, None]
            < seq_len.reshape(B, 1, 1)).to(dtype)


def _blend(m, new, old):
    return new if m is None else m * new + (1 - m) * old


@register_op("gru")
def _gru(ins, attrs, ctx):
    xs, w = x(ins, "Input"), x(ins, "Weight")
    h0, bias, seq_len = x(ins, "H0"), x(ins, "Bias"), x(ins, "SeqLen")
    B, T, three_d = xs.shape
    D = three_d // 3
    act_g = _ACTS[attrs.get("gate_activation", "sigmoid")]
    act_c = _ACTS[attrs.get("activation", "tanh")]
    origin = attrs.get("origin_mode", False)
    reverse = attrs.get("is_reverse", False)
    if reverse:
        xs = _reverse(xs, seq_len)
    if bias is not None:
        xs = xs + bias.reshape(1, 1, three_d)
    wu, wr, wc = w[:, :D], w[:, D:2 * D], w[:, 2 * D:]
    h = h0 if h0 is not None else torch.zeros((B, D), dtype=xs.dtype,
                                              device=xs.device)
    hs = []
    for t in range(T):
        xt = xs[:, t]
        u = act_g(xt[:, :D] + h @ wu)
        r = act_g(xt[:, D:2 * D] + h @ wr)
        c = act_c(xt[:, 2 * D:] + (r * h) @ wc)
        nh = u * h + (1 - u) * c if origin else (1 - u) * h + u * c
        h = _blend(_mask_t(seq_len, t, B, nh.dtype), nh, h)
        hs.append(h)
    hs = torch.stack(hs, dim=1)
    if reverse:
        hs = _reverse(hs, seq_len)
    if seq_len is not None:
        hs = hs * _valid_steps(seq_len, B, T, hs.dtype, hs.device)
    return out(Hidden=hs, LastHidden=h)


def _lstm_gates(xt, rec, w, D, act_g, act_c):
    """The four gates from the projected input xt and the recurrent state
    rec, in lstm_op.cc's order [W_i | W_f | W_c | W_o]."""
    i = act_g(xt[:, :D] + rec @ w[:, :D])
    f = act_g(xt[:, D:2 * D] + rec @ w[:, D:2 * D])
    cand = act_c(xt[:, 2 * D:3 * D] + rec @ w[:, 2 * D:3 * D])
    o = act_g(xt[:, 3 * D:] + rec @ w[:, 3 * D:])
    return i, f, cand, o


def _lstm_acts(attrs):
    return (_ACTS[attrs.get("gate_activation", "sigmoid")],
            _ACTS[attrs.get("cell_activation", "tanh")],
            _ACTS[attrs.get("candidate_activation", "tanh")])


def _refuse_peepholes(op, attrs):
    if attrs.get("use_peepholes", False):
        raise NotImplementedError(
            "%s op: use_peepholes is not implemented (%s_op.cc peephole "
            "weights); run with use_peepholes=False" % (op, op))


def _unroll(xs, seq_len, carry, step, reverse):
    """Runs ``step(carry, xt) -> (state, cell)`` over T with the freeze
    mask; returns the stacked [B, T, .] states and cells (reversed back,
    zero past each length) and the last carry."""
    B, T = xs.shape[0], xs.shape[1]
    states, cells = [], []
    for t in range(T):
        ns, nc = step(carry, xs[:, t])
        m = _mask_t(seq_len, t, B, ns.dtype)
        carry = (_blend(m, ns, carry[0]), _blend(m, nc, carry[1]))
        states.append(carry[0])
        cells.append(carry[1])
    hs, cs = torch.stack(states, dim=1), torch.stack(cells, dim=1)
    if reverse:
        hs, cs = _reverse(hs, seq_len), _reverse(cs, seq_len)
    if seq_len is not None:
        hs = hs * _valid_steps(seq_len, B, T, hs.dtype, hs.device)
        cs = cs * _valid_steps(seq_len, B, T, cs.dtype, cs.device)
    return hs, cs, carry


@register_op("lstm")
def _lstm(ins, attrs, ctx):
    xs, w = x(ins, "Input"), x(ins, "Weight")
    h0, c0, bias = x(ins, "H0"), x(ins, "C0"), x(ins, "Bias")
    seq_len = x(ins, "SeqLen")
    _refuse_peepholes("lstm", attrs)
    B, T, four_d = xs.shape
    D = four_d // 4
    act_g, act_c, act_h = _lstm_acts(attrs)
    reverse = attrs.get("is_reverse", False)
    if reverse:
        xs = _reverse(xs, seq_len)
    if bias is not None:
        xs = xs + bias.reshape(1, 1, four_d)
    zeros = torch.zeros((B, D), dtype=xs.dtype, device=xs.device)
    carry = (h0 if h0 is not None else zeros, c0 if c0 is not None else zeros)

    def step(carry, xt):
        h, c = carry
        i, f, cand, o = _lstm_gates(xt, h, w, D, act_g, act_c)
        nc = f * c + i * cand
        return o * act_h(nc), nc

    hs, cs, (h, c) = _unroll(xs, seq_len, carry, step, reverse)
    return out(Hidden=hs, Cell=cs, LastHidden=h, LastCell=c)


@register_op("lstmp")
def _lstmp(ins, attrs, ctx):
    """H0 is the hidden state [B, D], and the recurrence starts from its
    projection; an H0 of [B, P] (P != D) is taken as projected already."""
    xs, w, wp = x(ins, "Input"), x(ins, "Weight"), x(ins, "ProjWeight")
    bias, h0, c0 = x(ins, "Bias"), x(ins, "H0"), x(ins, "C0")
    seq_len = x(ins, "SeqLen")
    _refuse_peepholes("lstmp", attrs)
    B, T, four_d = xs.shape
    D = four_d // 4
    P = wp.shape[1]
    act_g, act_c, act_h = _lstm_acts(attrs)
    act_p = _ACTS[attrs.get("proj_activation", "identity")]
    reverse = attrs.get("is_reverse", False)
    if reverse:
        xs = _reverse(xs, seq_len)
    if bias is not None:
        xs = xs + bias.reshape(1, 1, four_d)
    if h0 is not None:
        r = act_p(h0 @ wp) if h0.shape[1] == D and D != P else h0
    else:
        r = torch.zeros((B, P), dtype=xs.dtype, device=xs.device)
    c = c0 if c0 is not None else torch.zeros((B, D), dtype=xs.dtype,
                                              device=xs.device)

    def step(carry, xt):
        r, c = carry
        i, f, cand, o = _lstm_gates(xt, r, w, D, act_g, act_c)
        nc = f * c + i * cand
        return act_p((o * act_h(nc)) @ wp), nc

    rs, cs, (r, c) = _unroll(xs, seq_len, (r, c), step, reverse)
    return out(Projection=rs, Cell=cs, LastProjection=r, LastCell=c)
