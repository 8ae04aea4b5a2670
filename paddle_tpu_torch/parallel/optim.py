"""Optimizers over nested dicts of tensors (counterpart of
``paddle_tpu/parallel/optim.py``).

Each factory returns ``(init_fn(params) -> opt_state,
update_fn(grads, opt_state, params, lr) -> (params, opt_state))``.  The
update runs under ``torch.no_grad`` and writes the parameters and moments
in place (the JAX step donates its state; here nothing else holds it).

Dtypes follow the reference's promotion rules: moments are
``zeros_like(params)`` (bf16 for bf16 params) and update in that dtype;
bias corrections are f32 because the step count's powers are f32 arrays;
the update is cast to the parameter dtype, with no f32 master copy.
"""

import contextlib

import torch

from .._tree import tree_leaves, tree_map

__all__ = ["sgd", "momentum", "adam", "adamw", "lamb", "norm_reduction"]

# When a leaf is a ZeRO shard (parallel/zero.py), per-param reductions (the
# LAMB trust-ratio norms) must span the whole param, not the local shard:
# zero.py wraps its sharded update in norm_reduction(psum over dp), and the
# norm becomes the square root of the psum of the shards' sums of squares,
# as the reference's _norm_sq.
_NORM_REDUCE = None


@contextlib.contextmanager
def norm_reduction(fn):
    global _NORM_REDUCE
    prev = _NORM_REDUCE
    _NORM_REDUCE = fn
    try:
        yield
    finally:
        _NORM_REDUCE = prev


def _norm(x):
    """The l2 norm of an f32 leaf; across its ZeRO shards under
    norm_reduction."""
    if _NORM_REDUCE is None:
        return torch.linalg.vector_norm(x)
    return torch.sqrt(_NORM_REDUCE(torch.sum(torch.square(x))))


def _tree_zeros(params):
    return tree_map(torch.zeros_like, params)


def sgd():
    """Parity: operators/optimizers/sgd_op.cc."""

    def init(params):
        return {}

    @torch.no_grad()
    def update(grads, state, params, lr):
        tree_map(lambda p, g: p.sub_(lr * g.to(p.dtype)), params, grads)
        return params, state

    return init, update


def momentum(mu=0.9, use_nesterov=False):
    """Parity: operators/optimizers/momentum_op.h.  The velocity is
    ``zeros_like(params)`` (bf16 for bf16 leaves) and updates in that dtype:
    ``mu * v + g`` and ``lr * v`` keep v's dtype, as a Python scalar (JAX's
    weakly typed ``mu``, and the ``lr`` a step is called with) does in JAX."""

    def init(params):
        return {"velocity": _tree_zeros(params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        def upd(p, g, v):
            v.mul_(mu).add_(g)
            if use_nesterov:
                p.sub_(lr * (g + mu * v))
            else:
                p.sub_(lr * v)

        tree_map(upd, params, grads, state["velocity"])
        return params, state

    return init, update


def _bias_corrections(step, beta1, beta2):
    """``beta ** step`` for both betas as f32 0-d tensors (the step count's
    powers are f32 arrays in the reference)."""
    stepf = step.float()
    f32 = dict(dtype=torch.float32, device=stepf.device)
    return (torch.tensor(beta1, **f32) ** stepf,
            torch.tensor(beta2, **f32) ** stepf)


def adam(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=None):
    """Parity: operators/optimizers/adam_op.h (bias-corrected).  The moments
    are ``zeros_like(params)`` and update in the parameter dtype; the step
    is ``scale * m / (sqrt(v) + eps)`` with the f32 0-d
    ``scale = lr * sqrt(1 - b2t) / (1 - b1t)``.  ``weight_decay`` (adamw)
    then subtracts ``lr * weight_decay * p`` of the old parameter."""

    def init(params):
        return {
            "m": _tree_zeros(params),
            "v": _tree_zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device),
        }

    @torch.no_grad()
    def update(grads, state, params, lr):
        step = state["step"] + 1
        b1t, b2t = _bias_corrections(step, beta1, beta2)
        scale = lr * torch.sqrt(1 - b2t) / (1 - b1t)

        def upd(p, g, m_, v_):
            m_.mul_(beta1).add_((1 - beta1) * g)
            v_.mul_(beta2).add_((1 - beta2) * g * g)
            decay = None if weight_decay is None else (lr * weight_decay) * p
            # f32, as an f32 0-d array over a bf16 array promotes in JAX
            p.sub_((scale * m_.float() / (torch.sqrt(v_) + eps).float())
                   .to(p.dtype))
            if decay is not None:
                p.sub_(decay)

        tree_map(upd, params, grads, state["m"], state["v"])
        state["step"] = step
        return params, state

    return init, update


def adamw(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01):
    """Decoupled weight decay variant (the AMP/BERT recipe)."""
    return adam(beta1, beta2, eps, weight_decay=weight_decay)


def lamb(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01):
    """Layer-adaptive large-batch optimizer (parity:
    operators/optimizers/lamb_op.h) — the BERT-pretraining optimizer.  The
    trust ratio is taken per leaf (a stacked [L, ...] leaf is one tensor, as
    in the reference) and is 1 when either norm is 0."""

    def init(params):
        return {
            "m": _tree_zeros(params),
            "v": _tree_zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device),
        }

    @torch.no_grad()
    def update(grads, state, params, lr):
        step = state["step"] + 1
        b1t, b2t = _bias_corrections(step, beta1, beta2)

        def upd(p, g, m_, v_):
            m_.mul_(beta1).add_((1 - beta1) * g)                    # p.dtype
            v_.mul_(beta2).add_((1 - beta2) * g * g)
            # f32, as a bf16 array over an f32 array promotes in JAX (torch
            # would keep bf16 against a 0-dim tensor)
            mhat = m_.float() / (1 - b1t)
            vhat = v_.float() / (1 - b2t)
            r = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
            w_norm = _norm(p.float())
            r_norm = _norm(r)
            one = torch.ones((), device=p.device)
            trust = torch.where(w_norm > 0,
                                torch.where(r_norm > 0, w_norm / r_norm, one),
                                one)
            p.sub_((lr * trust * r).to(p.dtype))

        tree_map(upd, params, grads, state["m"], state["v"])
        state["step"] = step
        return params, state

    return init, update

