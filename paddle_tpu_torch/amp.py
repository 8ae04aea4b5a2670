"""Automatic mixed precision (parity: fluid/contrib/mixed_precision/ —
decorate() decorator.py:27, fp16 white/black lists fp16_lists.py, dynamic loss
scaling decorator.py:216).

A copy of the JAX package's ``amp.py``.  The numeric policy is bfloat16
compute with float32 master weights; bf16's fp32-equal exponent range makes
loss scaling unnecessary, so the loss-scaling API is kept (reference parity)
but is an identity.  Instead of per-op cast insertion driven by white/black
lists, the executor casts float32 params/feeds to bf16 at the forward
boundary, and autograd returns float32 grads for the float32 master params
(the cast is part of the graph) — the same master-weight contract as
OptimizerWithMixedPrecision."""

import contextlib

__all__ = ["decorate", "amp_guard", "CustomOpLists", "AutoMixedPrecisionLists"]


class AutoMixedPrecisionLists:
    """Parity: fp16_lists.py — accepted and recorded; each op runs in the
    dtype of its bf16 inputs (cuBLAS and cuDNN accumulate bf16 products in
    f32)."""

    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = set(custom_white_list or [])
        self.black_list = set(custom_black_list or [])


CustomOpLists = AutoMixedPrecisionLists


class OptimizerWithMixedPrecision:
    """Parity: decorator.py:27."""

    def __init__(self, optimizer, amp_lists=None, init_loss_scaling=1.0,
                 use_dynamic_loss_scaling=False, **kwargs):
        self._optimizer = optimizer
        self._amp_lists = amp_lists
        self._loss_scaling = init_loss_scaling

    def get_loss_scaling(self):
        return self._loss_scaling

    def minimize(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        program = loss.block.program
        program._amp = {"enabled": True, "dtype": "bfloat16"}
        return self._optimizer.minimize(loss, startup_program, parameter_list, no_grad_set)

    def backward(self, loss, **kwargs):
        loss.block.program._amp = {"enabled": True, "dtype": "bfloat16"}
        return self._optimizer.backward(loss, **kwargs)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def __getattr__(self, item):
        return getattr(self._optimizer, item)


def decorate(optimizer, amp_lists=None, init_loss_scaling=1.0,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2, incr_ratio=2.0,
             decr_ratio=0.8, use_dynamic_loss_scaling=False):
    """Parity: fluid.contrib.mixed_precision.decorate."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling)


@contextlib.contextmanager
def amp_guard(enable=True, dtype="bfloat16"):
    """Dygraph-style AMP context: layers built inside tag the default program."""
    from .framework import default_main_program

    program = default_main_program()
    old = getattr(program, "_amp", None)
    program._amp = {"enabled": enable, "dtype": dtype}
    try:
        yield
    finally:
        program._amp = old
