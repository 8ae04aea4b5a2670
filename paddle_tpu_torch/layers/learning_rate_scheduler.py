"""LR schedules (parity: layers/learning_rate_scheduler.py — noam_decay,
exponential_decay, natural_exp_decay, inverse_time_decay, polynomial_decay,
piecewise_decay, cosine_decay, linear_lr_warmup).

Each schedule creates a persistable global step counter (incremented once per
program run, LRSched role) and ops computing the decayed LR into a var that
optimizers consume as LearningRate.  A copy of the JAX package's
``layers/learning_rate_scheduler.py``."""

import math

from ..layer_helper import LayerHelper
from ..framework import default_main_program, default_startup_program
from ..initializer import ConstantInitializer
from . import tensor as T
from . import math_ops as M

__all__ = [
    "noam_decay",
    "exponential_decay",
    "natural_exp_decay",
    "inverse_time_decay",
    "polynomial_decay",
    "piecewise_decay",
    "cosine_decay",
    "linear_lr_warmup",
]


def _global_step_counter(begin=0):
    """Parity: layers.autoincreased_step_counter(begin) — persistable scalar
    whose value on the t-th run is begin + t (increment happens before the
    schedule reads it, so the var starts at begin - 1)."""
    program = default_main_program()
    name = "@LR_DECAY_COUNTER@"
    block = program.global_block()
    if name in block.vars:
        return block.vars[name], False
    var = T.create_global_var([1], float(begin - 1), "float32",
                              persistable=True, name=name)
    with program._lr_schedule_guard():
        block.append_op(type="increment", inputs={"X": [var]}, outputs={"Out": [var]},
                        attrs={"step": 1.0})
    return var, True


def _create(fn, begin=0):
    program = default_main_program()
    with program._lr_schedule_guard():
        step, _ = _global_step_counter(begin)
        return fn(step)


def noam_decay(d_model, warmup_steps):
    def build(step):
        a = M.pow(step, -0.5)
        b = M.scale(step, scale=warmup_steps ** -1.5)
        m = M.elementwise_min(a, b)
        return M.scale(m, scale=d_model ** -0.5)

    # noam starts at step 1 (reference _decay_step_counter(begin=1); step^-0.5
    # at 0 would be inf)
    return _create(build, begin=1)


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    def build(step):
        div = M.scale(step, scale=1.0 / decay_steps)
        if staircase:
            div = M.floor(div)
        return M.scale(M.elementwise_pow(
            T.fill_constant([1], "float32", decay_rate), div), scale=learning_rate)

    return _create(build)


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    def build(step):
        div = M.scale(step, scale=1.0 / decay_steps)
        if staircase:
            div = M.floor(div)
        return M.scale(M.exp(M.scale(div, scale=-decay_rate)), scale=learning_rate)

    return _create(build)


def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    def build(step):
        div = M.scale(step, scale=1.0 / decay_steps)
        if staircase:
            div = M.floor(div)
        denom = M.scale(div, scale=decay_rate, bias=1.0)
        return M.elementwise_div(T.fill_constant([1], "float32", learning_rate), denom)

    return _create(build)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001, power=1.0,
                     cycle=False):
    def build(step):
        capped = M.elementwise_min(step, T.fill_constant([1], "float32", decay_steps))
        frac = M.scale(capped, scale=1.0 / decay_steps)
        one_minus = M.scale(frac, scale=-1.0, bias=1.0)
        p = M.pow(one_minus, factor=power)
        return M.scale(p, scale=learning_rate - end_learning_rate, bias=end_learning_rate)

    return _create(build)


def piecewise_decay(boundaries, values):
    """lr = values[i] for step in [boundaries[i-1], boundaries[i]) — strict
    less-than at each boundary (parity: reference
    layers/learning_rate_scheduler.py piecewise_decay 'step < b')."""

    def build(step):
        lr = T.fill_constant([1], "float32", values[-1])
        # build nested where from last boundary to first
        for b, v in zip(reversed(boundaries), reversed(values[:-1])):
            from .control_flow import less_than

            c = less_than(step, T.fill_constant([1], "float32", float(b)))
            lr = T.where(c, T.fill_constant([1], "float32", float(v)), lr)
        return lr

    return _create(build)


def cosine_decay(learning_rate, step_each_epoch, epochs):
    def build(step):
        epoch = M.floor(M.scale(step, scale=1.0 / step_each_epoch))
        frac = M.scale(epoch, scale=math.pi / epochs)
        return M.scale(M.cos(frac), scale=0.5 * learning_rate, bias=0.0,
                       bias_after_scale=False) + (0.5 * learning_rate)

    return _create(build)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    def build(step):
        from .control_flow import less_than

        if not hasattr(learning_rate, "name"):
            base = T.fill_constant([1], "float32", float(learning_rate))
        else:
            base = learning_rate
        frac = M.scale(step, scale=1.0 / warmup_steps)
        warm = M.scale(frac, scale=end_lr - start_lr, bias=start_lr, bias_after_scale=True)
        c = less_than(step, T.fill_constant([1], "float32", float(warmup_steps)))
        return T.where(c, warm, base)

    return _create(build)
