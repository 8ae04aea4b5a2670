"""Math op rules on tensors: the elementwise binaries, compares and logical
ops, scale, sum, matmul, mul, bmm, the unary functions, pow, the clips,
the reductions, mean, arg_max/arg_min, argsort, top_k, cumsum, the
isfinite family, kron, dot and p_norm (counterparts of every rule in
``paddle_tpu/ops/math_ops.py``).

Reference parity: operators/elementwise/, controlflow/compare_op.cc,
logical_op.cc, scale_op.cc, sum_op.cc, matmul_op.cc, mul_op.cc,
bmm_op.cc, mean_op.cc, reduce_ops/, activation_op.cc (the unary
functions), pow_op, clip_op.cc, clip_by_norm_op.cc,
squared_l2_norm_op.cc, arg_min_max_op_base.h, argsort_op.cc,
top_k_op.cc, cum_op.h, isfinite_op.cc, kron_op.cc, dot_op.cc,
p_norm_op.cc.  A SelectedRows
gradient (``sparse.py``) passes ``scale``, a binary by a scalar, ``sum``
and the clips as the JAX rules pass it (math/selected_rows_functor.cc).
"""

import math

import torch

from ..registry import register_op
from ..sparse import SelectedRows
from .common import exact_matmul, lax_top_k, x, out, promote_float


def _bcast(a, b, axis):
    """Reference elementwise broadcast semantics (elementwise_op_function.h):
    Y's shape must match a contiguous suffix-run of X's shape starting at
    `axis`; numpy-style trailing broadcast when axis == -1."""
    if axis == -1 or a.ndim == b.ndim:
        return a, b
    # align b's dims to a's at position `axis`
    expand = [1] * a.ndim
    for i, s in enumerate(b.shape):
        expand[axis + i] = s
    return a, b.reshape(expand)


def _register_binary(name, fn):
    @register_op(name)
    def _rule(ins, attrs, ctx, fn=fn):
        a, b = x(ins, "X"), x(ins, "Y")
        if isinstance(a, SelectedRows):
            if b.numel() == 1:
                # sparse grad x scalar (the global-norm clip factor, a
                # shape-[1] fluid scalar included): map over the rows'
                # values, keep the sparse representation
                return out(Out=SelectedRows(a.rows, fn(a.values, b.reshape(())),
                                            a.height))
            raise NotImplementedError(
                "%s: SelectedRows lhs supports only scalar rhs" % name)
        a, b = _bcast(a, b, int(attrs.get("axis", -1)))
        return out(Out=fn(a, b))


_register_binary("elementwise_add", torch.add)
_register_binary("elementwise_sub", torch.sub)
_register_binary("elementwise_mul", torch.mul)
# true division, integers included, as jnp.divide
_register_binary("elementwise_div", torch.true_divide)
# bool ** bool in int32, as jnp.power (torch.pow refuses bool)
_register_binary("elementwise_pow", lambda a, b: torch.pow(
    *(t.int() if t.dtype == torch.bool else t for t in (a, b))))
# NaN propagates and a tie splits the gradient in halves, as jnp.maximum
_register_binary("elementwise_max", torch.maximum)
# ties split the gradient in halves, as jnp.minimum
_register_binary("elementwise_min", torch.minimum)
# the remainder takes the divisor's sign, as jnp.mod
_register_binary("elementwise_mod", torch.remainder)


def _floor_divide(a, b):
    """``jnp.floor_divide``.  Floats: floor(a / b) with Python's correction
    (c10's div_floor, the remainder route of JAX's ``_float_divmod``), and
    NaN where b is 0, as JAX's remainder by 0 is NaN.  Integers: the
    truncating quotient moved down one where the signs differ and the
    remainder is not 0, with XLA's x / 0 = -1 and x % 0 = x, so x // 0 is
    -1 at x = 0 and -2 elsewhere, and INT_MIN // -1 is INT_MIN; bool
    computes in int32, as JAX promotes it.  No gradient, as JAX's is 0."""
    if a.dtype == torch.bool:
        a = a.int()
    if b.dtype == torch.bool:
        b = b.int()
    if a.is_floating_point() or b.is_floating_point():
        return torch.where(b == 0, float("nan"), torch.floor_divide(a, b))
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    wraps = (a == torch.iinfo(dt).min) & (b == -1)
    undefined = (b == 0) | wraps
    q = torch.div(a, torch.where(undefined, 1, b), rounding_mode="floor")
    by_zero = torch.where(a == 0, -1, -2).to(dt)
    return torch.where(b == 0, by_zero, torch.where(wraps, a, q))


_register_binary("elementwise_floordiv", _floor_divide)

_register_binary("less_than", torch.lt)
_register_binary("less_equal", torch.le)
_register_binary("greater_than", torch.gt)
_register_binary("greater_equal", torch.ge)
_register_binary("equal", torch.eq)
_register_binary("not_equal", torch.ne)

_register_binary("logical_and", torch.logical_and)
_register_binary("logical_or", torch.logical_or)
_register_binary("logical_xor", torch.logical_xor)


@register_op("logical_not")
def _logical_not(ins, attrs, ctx):
    return out(Out=torch.logical_not(x(ins, "X")))


@register_op("scale")
def _scale(ins, attrs, ctx):
    """An integer input computes in f32 and casts back, as JAX promotes an
    int array times a Python float; a bool input gives f32, as in JAX."""
    v = x(ins, "X")
    scale = attrs.get("scale", 1.0)
    bias = attrs.get("bias", 0.0)
    if isinstance(v, SelectedRows):
        return out(Out=SelectedRows(v.rows, v.values * scale + bias,
                                    v.height))
    w = v if v.is_floating_point() else v.to(torch.float32)
    if attrs.get("bias_after_scale", True):
        r = w * scale + bias
    else:
        r = (w + bias) * scale
    integer = not v.is_floating_point() and v.dtype != torch.bool
    return out(Out=r.to(v.dtype) if integer else r)


@register_op("sum")
def _sum(ins, attrs, ctx):
    vs = ins["X"]
    sparse = [v for v in vs if isinstance(v, SelectedRows)]
    if sparse:
        if len(sparse) == len(vs):
            # SelectedRows + SelectedRows: concatenate the slices; duplicate
            # rows merge when applied (MergeAdd semantics)
            return out(Out=SelectedRows(
                torch.cat([v.rows for v in sparse]),
                torch.cat([v.values for v in sparse]), sparse[0].height))
        # a SelectedRows gradient plus a dense term (the regularizer's
        # pattern): the term is added to the touched rows only, after the
        # rows are merged, so a duplicated id gets it once; merged() parks
        # empty slots at row == height, whose term is zero
        assert len(sparse) == 1, "at most one sparse addend supported"
        rows, vals = sparse[0].merged()
        height = sparse[0].height
        safe = rows.clamp(max=height - 1)
        valid = (rows < height)[:, None]
        for d in vs:
            if not isinstance(d, SelectedRows):
                vals = vals + torch.where(valid, d[safe], 0.0)
        return out(Out=SelectedRows(rows, vals, height))
    r = vs[0]
    for v in vs[1:]:
        r = r + v
    return out(Out=r)


@register_op("mul")
def _mul(ins, attrs, ctx):
    """Reference mul_op.cc: flatten X to 2-D at x_num_col_dims, Y at
    y_num_col_dims, matmul, restore leading dims."""
    a, b = x(ins, "X"), x(ins, "Y")
    xd = int(attrs.get("x_num_col_dims", 1))
    yd = int(attrs.get("y_num_col_dims", 1))

    def _flat2(t, d):
        return t.reshape(math.prod(t.shape[:d]), math.prod(t.shape[d:]))

    r = _flat2(a, xd) @ _flat2(b, yd)
    return out(Out=r.reshape(tuple(a.shape[:xd]) + tuple(b.shape[yd:])))


@register_op("matmul")
def _matmul(ins, attrs, ctx):
    """``jnp.matmul`` semantics (a 1-D side is a vector, leading dims
    broadcast) after the optional swaps of the last two axes; ``alpha``
    scales the product."""
    a, b = x(ins, "X"), x(ins, "Y")
    if attrs.get("transpose_X", False):
        a = a.transpose(-1, -2)
    if attrs.get("transpose_Y", False):
        b = b.transpose(-1, -2)
    r = exact_matmul(a, b)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        r = r * alpha
    return out(Out=r)


@register_op("bmm")
def _bmm(ins, attrs, ctx):
    return out(Out=exact_matmul(x(ins, "X"), x(ins, "Y")))


def _register_unary(name, fn):
    @register_op(name)
    def _rule(ins, attrs, ctx, fn=fn):
        return out(Out=fn(x(ins, "X")))


def _abs_like_jax(v):
    """``jnp.abs``: bool and integers keep their dtype; for floats the
    gradient at +0 and -0 is 1, as JAX's select(x >= 0, g, -g) (torch's
    sign(x) gives 0), and -0 comes out +0."""
    if v.dtype == torch.bool:
        return v
    if not v.is_floating_point():
        return torch.abs(v)
    return torch.where(v >= 0, v, -v) + 0.0


# integer inputs: abs, square, ceil and round keep the dtype, the others
# compute in f32, as the jnp functions
_register_unary("abs", _abs_like_jax)
_register_unary("rsqrt", torch.rsqrt)
_register_unary("square", torch.square)
_register_unary("exp", torch.exp)
_register_unary("log", torch.log)
_register_unary("log2", torch.log2)
_register_unary("log10", torch.log10)
_register_unary("log1p", torch.log1p)
_register_unary("sin", torch.sin)
_register_unary("cos", torch.cos)
_register_unary("tan", torch.tan)
_register_unary("asin", torch.asin)
_register_unary("acos", torch.acos)
_register_unary("atan", torch.atan)
_register_unary("sinh", torch.sinh)
_register_unary("cosh", torch.cosh)
_register_unary("ceil", lambda v: torch.ceil(v) if v.is_floating_point() else v)
# halves to even, as jnp.round
_register_unary("round", lambda v: torch.round(v) if v.is_floating_point() else v)
_register_unary("reciprocal", torch.reciprocal)
_register_unary("erf", torch.erf)


@register_op("pow")
def _pow(ins, attrs, ctx):
    return out(Out=torch.pow(x(ins, "X"), attrs.get("factor", 1.0)))


@register_op("floor")
def _floor(ins, attrs, ctx):
    """Integers and bool come back as they are, as from ``jnp.floor``."""
    v = x(ins, "X")
    return out(Out=torch.floor(v) if v.is_floating_point() else v)


@register_op("sqrt")
def _sqrt(ins, attrs, ctx):
    return out(Out=torch.sqrt(x(ins, "X")))


@register_op("sign")
def _sign(ins, attrs, ctx):
    """-1, 0 or 1; NaN stays NaN, as ``jnp.sign``."""
    v = x(ins, "X")
    return out(Out=torch.where(torch.isnan(v), v, torch.sign(v))
               if v.is_floating_point() else torch.sign(v))


def _clip_values(v, lo, hi):
    """``jnp.clip``: a maximum then a minimum, so a value exactly at a
    bound takes half its gradient, as those two give it."""
    v = torch.maximum(v, torch.tensor(lo, dtype=v.dtype, device=v.device))
    return torch.minimum(v, torch.tensor(hi, dtype=v.dtype, device=v.device))


@register_op("clip")
def _clip(ins, attrs, ctx):
    """A SelectedRows input is merged first: duplicate ids sum before the
    clip, as the dense gradient would."""
    v = x(ins, "X")
    if isinstance(v, SelectedRows):
        rows, vals = v.merged()
        return out(Out=SelectedRows(
            rows, _clip_values(vals, attrs["min"], attrs["max"]), v.height))
    # integers and bool clip in f32, as jnp.clip with float bounds gives
    return out(Out=_clip_values(promote_float(v), attrs["min"], attrs["max"]))


def _clipped_by_norm(v, max_norm):
    norm = torch.sqrt(torch.sum(torch.square(v)))
    return torch.where(norm > max_norm, v * (max_norm / norm), v)


@register_op("clip_by_norm")
def _clip_by_norm(ins, attrs, ctx):
    """A SelectedRows input's norm is the norm of its merged rows (the
    dense gradient's norm, clip_by_norm_op.h)."""
    v = x(ins, "X")
    max_norm = attrs["max_norm"]
    if isinstance(v, SelectedRows):
        rows, vals = v.merged()
        return out(Out=SelectedRows(rows, _clipped_by_norm(vals, max_norm),
                                    v.height))
    return out(Out=_clipped_by_norm(v, max_norm))


@register_op("squared_l2_norm")
def _squared_l2_norm(ins, attrs, ctx):
    """A SelectedRows input sums duplicate ids before squaring."""
    v = x(ins, "X")
    if isinstance(v, SelectedRows):
        _, v = v.merged()
    return out(Out=torch.sum(torch.square(v)).reshape(()))


def _reduce(fn, over_none=lambda v: v):
    """attrs: dim (default [0]), keep_dim, reduce_all.  ``fn(v, dims,
    keep)`` reduces over a tuple of dims, as ``jnp.sum(axis=...)``.  An
    empty ``dim`` list without reduce_all reduces no axis, as
    ``jnp.sum(axis=())`` (torch reads ``dim=()`` as every axis):
    ``over_none(v)`` gives the input in the dtype the reduction would."""
    def rule(ins, attrs, ctx):
        v = x(ins, "X")
        if attrs.get("reduce_all", False):
            dims = tuple(range(v.ndim))
        else:
            dims = tuple(a if a >= 0 else a + v.ndim
                         for a in attrs.get("dim", [0]))
            if not dims:
                return out(Out=over_none(v))
        return out(Out=fn(v, dims, bool(attrs.get("keep_dim", False))))

    return rule


def _one_dim_at_a_time(op):
    """A reduction torch takes over one dim at a time (prod, all, any),
    applied over each of ``dims`` from the last."""
    def fn(v, dims, keep):
        for d in sorted(set(dims), reverse=True):
            v = op(v, dim=d, keepdim=keep)
        return v

    return fn


def _summed(v):
    """``v`` in the dtype torch's sum and prod give it: integers and bool
    widen to int64 (JAX's int32 under x64 off; the values agree)."""
    return v if v.is_floating_point() else v.to(torch.int64)


register_op("reduce_sum")(_reduce(lambda v, d, k: v.sum(dim=d, keepdim=k),
                                  _summed))
# integers and bool average in f32, as jnp.mean
register_op("reduce_mean")(_reduce(
    lambda v, d, k: promote_float(v).mean(dim=d, keepdim=k), promote_float))
# amax/amin, as jnp.max/min: tied extremes share the gradient equally
register_op("reduce_max")(_reduce(lambda v, d, k: v.amax(dim=d, keepdim=k)))
register_op("reduce_min")(_reduce(lambda v, d, k: v.amin(dim=d, keepdim=k)))
register_op("reduce_prod")(_reduce(_one_dim_at_a_time(torch.prod), _summed))
register_op("reduce_all")(_reduce(_one_dim_at_a_time(torch.all),
                                  lambda v: v.bool()))
register_op("reduce_any")(_reduce(_one_dim_at_a_time(torch.any),
                                  lambda v: v.bool()))


@register_op("mean")
def _mean(ins, attrs, ctx):
    return out(Out=promote_float(x(ins, "X")).mean().reshape(()))


@register_op("top_k")
def _top_k(ins, attrs, ctx):
    """The k largest along the last axis, as ``lax.top_k`` picks them
    (``common.lax_top_k``: ties to the lower index, +0 above -0)."""
    vals, idx = lax_top_k(x(ins, "X"), int(attrs["k"]))
    return out(Out=vals, Indices=idx)


def _bool_as_int(v):
    return v.to(torch.uint8) if v.dtype == torch.bool else v


@register_op("arg_max")
def _arg_max(ins, attrs, ctx):
    """The first maximum; a NaN counts as the maximum, as ``jnp.argmax``."""
    return out(Out=torch.argmax(_bool_as_int(x(ins, "X")),
                                dim=int(attrs.get("axis", -1))))


@register_op("arg_min")
def _arg_min(ins, attrs, ctx):
    return out(Out=torch.argmin(_bool_as_int(x(ins, "X")),
                                dim=int(attrs.get("axis", -1))))


@register_op("argsort")
def _argsort(ins, attrs, ctx):
    """A stable sort, ascending or descending (ties keep their order, NaN
    sorts as the largest), as ``jnp.argsort``."""
    v = x(ins, "X")
    vals, idx = torch.sort(v, dim=int(attrs.get("axis", -1)), stable=True,
                           descending=bool(attrs.get("descending", False)))
    return out(Out=vals, Indices=idx)


@register_op("cumsum")
def _cumsum(ins, attrs, ctx):
    """``reverse`` composes with ``exclusive`` as in cum_op.h: a reverse
    sum is flip(cumsum(flip)); an exclusive one shifts by one place."""
    v = x(ins, "X")
    axis = int(attrs.get("axis", -1)) % v.ndim
    if attrs.get("reverse", False):
        v = torch.flip(v, (axis,))
    r = torch.cumsum(v, dim=axis)
    if attrs.get("exclusive", False):
        r = torch.cat([torch.zeros_like(r.narrow(axis, 0, 1)),
                       r.narrow(axis, 0, r.shape[axis] - 1)], dim=axis)
    if attrs.get("reverse", False):
        r = torch.flip(r, (axis,))
    return out(Out=r)


@register_op("isfinite")
def _isfinite(ins, attrs, ctx):
    """One bool of shape [1]: whether every element is finite."""
    return out(Out=torch.isfinite(x(ins, "X")).all().reshape(1))


@register_op("isnan")
def _isnan(ins, attrs, ctx):
    return out(Out=torch.isnan(x(ins, "X")))


@register_op("isinf")
def _isinf(ins, attrs, ctx):
    return out(Out=torch.isinf(x(ins, "X")))


@register_op("kron")
def _kron(ins, attrs, ctx):
    return out(Out=torch.kron(x(ins, "X"), x(ins, "Y")))


@register_op("dot")
def _dot(ins, attrs, ctx):
    a, b = x(ins, "X"), x(ins, "Y")
    return out(Out=(a * b).sum(dim=-1, keepdim=True))


def _vector_norm(v, p, dims, keep):
    """``jnp.linalg.vector_norm``'s compositions, whose gradients at a zero
    vector this keeps: p = 1 a sum of |x| (1 at 0, as ``_abs_like_jax``),
    p = 2 sqrt(sum x x) (NaN at 0), inf the largest |x| with an initial 0
    (the tie with it halves the gradient), else (sum |x|^p)^(1 / p) with
    1 / p rounded to f32, as JAX makes it a constant of x's dtype."""
    a = _abs_like_jax(v)
    if p == math.inf:
        return torch.maximum(a.amax(dim=dims, keepdim=keep),
                             torch.zeros((), dtype=v.dtype, device=v.device))
    if p == -math.inf:
        return a.amin(dim=dims, keepdim=keep)
    if p == 0:
        return (v != 0).to(v.dtype).sum(dim=dims, keepdim=keep)
    if p == 1:
        return a.sum(dim=dims, keepdim=keep)
    if p == 2:
        return torch.sqrt((v * v).sum(dim=dims, keepdim=keep))
    inv = torch.tensor(1.0 / p, dtype=v.dtype).item()
    return torch.pow(torch.pow(a, p).sum(dim=dims, keepdim=keep), inv)


def _singular_values(v):
    """The singular values of each matrix of [..., m, n]; NaN for a matrix
    holding a NaN or an infinity, as the JAX SVD gives (torch's raises on
    the CPU: its LAPACK does not converge)."""
    bad = ~torch.isfinite(v).all(dim=-1, keepdim=True).all(dim=-2, keepdim=True)
    s = torch.linalg.svdvals(torch.where(bad, 0.0, v))
    return torch.where(bad[..., 0], float("nan"), s)


@register_op("p_norm")
def _p_norm(ins, attrs, ctx):
    """``jnp.linalg.norm(x, ord=porder, axis, keepdims)``: one axis (or a
    1-D input with none) gives the vector norm; two axes (or a 2-D input
    with none) the matrix norm of that order, porder 2 the largest
    singular value with an initial 0.  Integer and bool inputs compute in
    f32, as ``jnp.linalg.norm`` promotes them."""
    v = promote_float(x(ins, "X"))
    p = attrs.get("porder", 2.0)
    keep = bool(attrs.get("keepdim", False))
    axis = attrs.get("axis")
    if axis is None:
        dims = tuple(range(v.ndim))
    else:
        dims = tuple(d % v.ndim for d in (
            axis if isinstance(axis, (list, tuple)) else (axis,)))
    if len(dims) == 1:
        return out(Out=_vector_norm(v, float(p), dims, keep))
    if len(dims) != 2:
        raise ValueError("p_norm: improper number of axes %r for a norm"
                         % (dims,))
    if p not in (2, -2, "nuc"):
        return out(Out=torch.linalg.matrix_norm(v, ord=p, dim=dims,
                                                keepdim=keep))
    s = _singular_values(torch.movedim(v, dims, (-2, -1)))
    if p == 2:
        r = torch.maximum(s.amax(dim=-1),
                          torch.zeros((), dtype=v.dtype, device=v.device))
    else:
        r = s.amin(dim=-1) if p == -2 else s.sum(dim=-1)
    if keep:
        for d in sorted(dims):
            r = r.unsqueeze(d)
    return out(Out=r)


@register_op("maximum_entry_count")
def _maximum_entry_count(ins, attrs, ctx):
    """Registered only to refuse, as the JAX package's placeholder does."""
    raise NotImplementedError
