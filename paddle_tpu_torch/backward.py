"""Autodiff over captured programs.

Parity surface: python/paddle/fluid/backward.py:933 append_backward — the
reference walks ops in reverse and synthesizes grad OpDescs via per-op grad
makers (grad_op_desc_maker.h).  Here, as in the JAX package (this is a copy
of its ``backward.py``), the executor differentiates: ``torch.autograd.grad``
over the forward section.  append_backward records a single `backward_meta`
op marking the loss and the trainable params, and declares the named
`<param>@GRAD` variables so that downstream optimizer ops (and user fetches)
see the same contract as the reference.  Recompute/checkpointing
(backward.py:576, optimizer.py:3313 RecomputeOptimizer) sets the use_remat
attr, which the port's executor does not run yet: it raises.
"""

from .framework import (
    Parameter,
    Variable,
    default_main_program,
    OpRole,
)

__all__ = ["append_backward", "gradients"]


GRAD_SUFFIX = "@GRAD"


def _grad_name(name):
    return name + GRAD_SUFFIX


def append_backward(loss, parameter_list=None, no_grad_set=None, callbacks=None,
                    checkpoints=None):
    """Append the backward section for `loss`; returns [(param, grad_var)].

    Reference behavior at backward.py:933: appends grad ops for every
    parameter contributing to loss and returns param/grad pairs in the order
    the params were created.
    """
    program = loss.block.program
    block = program.global_block()

    if parameter_list is not None:
        params = []
        for p in parameter_list:
            name = p.name if isinstance(p, Variable) else p
            params.append(block.var(name))
    else:
        params = [p for p in block.all_parameters() if p.trainable]
    no_grad = set()
    if no_grad_set:
        no_grad = {v.name if isinstance(v, Variable) else v for v in no_grad_set}
    params = [p for p in params if p.name not in no_grad]

    param_and_grads = []
    with program._backward_role_guard():
        for p in params:
            g = block.create_var(
                name=_grad_name(p.name),
                shape=p.shape,
                dtype=p.dtype,
                persistable=False,
                stop_gradient=True,
            )
            param_and_grads.append((p, g))
        block.append_op(
            type="backward_meta",
            inputs={"Loss": [loss]},
            outputs={"Grads": [g for _, g in param_and_grads]},
            attrs={
                "loss_name": loss.name,
                "param_names": [p.name for p, _ in param_and_grads],
                "use_remat": bool(checkpoints),
                "op_role": OpRole.Backward,
            },
        )
    program._backward_info = (
        loss.name,
        [p.name for p, _ in param_and_grads],
        [g.name for _, g in param_and_grads],
    )
    return param_and_grads


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Parity: backward.py calc_gradient :1199 — d(targets)/d(inputs).

    Implemented by running the program's forward section and differentiating
    it with autograd; used by tests and double-backward-style utilities.  Returns grad
    Variables wired through a backward_meta-like op is unnecessary here; for
    program-mode users, append_backward is the main path, so this evaluates
    eagerly at executor time via a dedicated fetch program.
    """
    target = targets[0] if isinstance(targets, (list, tuple)) else targets
    program = target.block.program
    block = program.global_block()
    grads = []
    names = [v.name if isinstance(v, Variable) else v for v in
             (inputs if isinstance(inputs, (list, tuple)) else [inputs])]
    with program._backward_role_guard():
        for n in names:
            v = block.var(n)
            g = block.create_var(
                name=_grad_name(n), shape=v.shape, dtype=v.dtype, stop_gradient=True
            )
            grads.append(g)
        block.append_op(
            type="backward_meta",
            inputs={"Loss": [target]},
            outputs={"Grads": grads},
            attrs={
                "loss_name": target.name,
                "param_names": names,
                "use_remat": False,
                "op_role": OpRole.Backward,
            },
        )
    return grads
