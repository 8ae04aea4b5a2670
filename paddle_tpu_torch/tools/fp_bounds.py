"""Per-element error bounds of f32 arithmetic, derived from the arithmetic,
for the checks that hold a result whose order of additions is not fixed
(the sparse merge's ``index_add_`` route against its kernel route, the
card against the CPU) to an exact float64 recomputation.

The model.  Every f32 operation the port's code performs is IEEE
round-to-nearest (the card's and the CPU's elementwise kernels, sums,
``sqrt`` and division alike), so by the standard model with underflow
(Higham, *Accuracy and Stability of Numerical Algorithms*, eq. 2.8)

    fl(a op b) = (a op b)(1 + d) + t,   |d| <= u = 2^-24,   |t| <= 2^-149,

where ``t`` is the absolute error of a result in f32's subnormal range
(2^-149 is f32's smallest subnormal; round to nearest keeps it under half
that).  Without ``t`` a relative bound is wrong near underflow:
(1 - b2) g^2 is 0 in f32 for |g| below about 1e-21 while its exact value is
not, which is every relative bound's "infinitely many" times.  The float64
reference is itself rounded, 2^-53 relative per operation; that is folded
into the unit, ``UNIT = 2^-24 + 2^-52``, so a bound covers the distance
between the f32 result and the float64 reference, not only the exact value.

Sums of n terms in any order (the merge of n duplicate ids, by the
segment kernel or by ``index_add_``'s atomics): the textbook bound

    |fl(sum) - sum| <= gamma(n - 1) * sum |x_i| + (n - 1) 2^-149,
    gamma(k) = k u / (1 - k u),

with the float64 reference's gamma_64(n - 1) sum |x_i| added.  A run of
one or two terms has at most one rounding, which no order changes, so
those are held bit for bit to numpy's f32 sum instead.

Longer expressions (Adam's update of one element) propagate bounds through
each operation with ``Bounded``: a float64 reference value ``r`` and a bound
``e`` on the distance of the f32 computation from it,

    a +- b:  e = ea + eb + UNIT (|r| + ea + eb) + 2^-149
    a * b:   e = |ra| eb + |rb| ea + ea eb + UNIT (|r| + that) + 2^-149
    a / b:   e = (ea + |r| eb) / (|rb| - eb) + UNIT (|r| + that) + 2^-149
    sqrt a:  e = min(sqrt ea, ea / (sqrt ra + sqrt(max(ra - ea, 0))))
                 + UNIT (|r| + that) + 2^-149
    a constant written as a double and used in f32: e = u |c|.

The bounds are worst cases: an element whose every rounding goes the same
way by nearly half a unit reaches them, so over millions of elements the
largest ratio of error to bound can approach 1; above 1 the arithmetic is
not what this model says.

Op rules, operation by operation (``rule_bounds``).  An op rule run on the
card in f32 is held to the same rule run on the CPU in float64, within a
bound that ``BoundMode`` derives from the rule's own operations: it runs the
float64 rule (forward and, with a cotangent, the autograd backward) under a
``TorchDispatchMode`` that carries, beside each tensor, a bound on the
distance of the card's f32 value from it, and propagates it through each
ATen op:

- an elementwise op y = f(a, b, ...) carries its inputs' bounds by
  evaluating f at the corners a +- ea, b +- eb (f is monotone or convex
  over so short an interval), then adds its own rounding: half an ulp
  for the IEEE-rounded operations (+ - * /, sqrt, 1/x), n ulps for the
  functions of the CUDA math library, n from the CUDA C++ Programming
  Guide's table of maximum ulp errors (``CUDA_ULPS``; an ulp of y is at
  most 2^-23 |y|); selections (max, where, clamp, abs) add nothing;
- a linear op whose outputs are sums of its inputs' elements (copies,
  views, pads, gathers, scatters, cumsum, sum: counts n from the op on
  ones) carries op(e) and adds gamma(n - 1) op(|x| + e) for the order of
  the additions; a multilinear one (mm, bmm, convolution and its
  gradients: n products a term) carries op(|a| + ea, |b| + eb) - op(|a|,
  |b|) and adds gamma(n) op(|a| + ea, |b| + eb);
- a fused kernel (softmax, log_softmax, gelu, log-sigmoid, logaddexp and
  their gradients, the antialiased resize, the vector norm, the SVD) is
  taken apart into the operations its CUDA code performs, each bounded as
  above;
- a constant (a Python float, a tensor the rule creates) carries its own
  rounding to f32; the rule's inputs and the cotangent are exact.

Where every bound of an output is 0 (copies, selections, integer and bool
results) the card must equal the CPU's f32 rule bit for bit.  A comparison
whose operands lie within their bounds of each other cannot say which way
the card decided: the mode records it (``ambiguous``) and the check fails.
"""

import contextlib
import itertools
import math

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

__all__ = ["U32", "U64", "UNIT", "TINY", "gamma", "Bounded",
           "segment_sums", "merge_check", "ratio", "sparse_adam_reference",
           "sparse_adam_check", "sparse_sgd_check", "capture_sparse_updates",
           "check_sparse_update", "CUDA_ULPS", "BoundMode", "rule_bounds",
           "hold_to_bound"]

U32 = 2.0 ** -24
U64 = 2.0 ** -53
UNIT = U32 + 2.0 * U64
TINY = 2.0 ** -149


def gamma(k, u=U32):
    k = np.asarray(k, np.float64)
    return k * u / (1.0 - k * u)


def ratio(got, want, bound):
    """max |got - want| / bound over the elements (0 where both are 0)."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    bound = np.asarray(bound, np.float64)
    r = np.divide(err, bound, out=np.zeros_like(err), where=bound > 0)
    r[(bound == 0) & (err > 0)] = np.inf
    return float(r.max(initial=0.0)), float(err.max(initial=0.0))


class Bounded:
    """A float64 reference ``r`` and a bound ``e`` (arrays of one shape,
    or broadcastable) on how far the f32 computation of the same
    expression lies from ``r``."""

    __slots__ = ("r", "e")

    def __init__(self, r, e):
        self.r = np.asarray(r, np.float64)
        self.e = np.asarray(e, np.float64)

    @classmethod
    def exact(cls, x):
        """An f32 input taken as it is (the old state, a merged
        gradient): no error."""
        x = np.asarray(x, np.float64)
        return cls(x, np.zeros_like(x))

    @classmethod
    def const(cls, c):
        """A double constant (``beta1``, ``1 - beta1``) rounded to f32 where
        it meets an f32 tensor."""
        c = float(c)
        return cls(c, U32 * abs(c))

    @staticmethod
    def _round(r, e):
        return Bounded(r, e + UNIT * (np.abs(r) + e) + TINY)

    def __add__(self, o):
        return Bounded._round(self.r + o.r, self.e + o.e)

    def __sub__(self, o):
        return Bounded._round(self.r - o.r, self.e + o.e)

    def __mul__(self, o):
        return Bounded._round(self.r * o.r, np.abs(self.r) * o.e
                              + np.abs(o.r) * self.e + self.e * o.e)

    def __truediv__(self, o):
        den = np.abs(o.r) - o.e
        if np.any(den <= 0):
            raise ValueError("divisor's bound reaches 0")
        r = self.r / o.r
        return Bounded._round(r, (self.e + np.abs(r) * o.e) / den)

    def sqrt(self):
        r = np.sqrt(np.maximum(self.r, 0.0))
        lo = np.sqrt(np.maximum(self.r - self.e, 0.0))
        den = r + lo
        lin = np.divide(self.e, den, out=np.full_like(r + self.e, np.inf),
                        where=den > 0)
        return Bounded._round(r, np.minimum(np.sqrt(self.e), lin))

    def take(self, idx):
        return Bounded(self.r[idx] if self.r.ndim else self.r,
                       self.e[idx] if self.e.ndim else self.e)


def segment_sums(rows, values):
    """(unique rows sorted, float64 sums [U, D], sums of |x| [U, D], run
    lengths [U], first and second terms of each run in f32) of ``values``
    [N, D] by ``rows`` [N]."""
    rows = np.asarray(rows)
    values = np.asarray(values, np.float32).reshape(len(rows), -1)
    order = np.argsort(rows, kind="stable")
    r, v = rows[order], values[order]
    starts = np.flatnonzero(np.r_[True, r[1:] != r[:-1]]) if len(r) else \
        np.zeros(0, np.int64)
    v64 = v.astype(np.float64)
    sums = np.add.reduceat(v64, starts, axis=0)
    abs_sums = np.add.reduceat(np.abs(v64), starts, axis=0)
    n = np.diff(np.r_[starts, len(r)])
    second = np.where((n >= 2)[:, None], v[np.minimum(starts + 1, len(r) - 1)],
                      np.float32(0))
    return r[starts], sums, abs_sums, n, v[starts], second


def merge_check(rows, values, out_rows, out_values, height):
    """Hold one route's merge of duplicate rows (``sparse.merge_rows`` or
    the segment kernel: each unique row once, every other slot's row the
    sentinel ``height``) to the exact sums of the same contributions.
    Runs of one or two terms must be bit-equal to numpy's f32 sum; longer
    runs lie within gamma(n - 1) sum |x| + (n - 1) 2^-149 plus the float64
    reference's gamma_64(n - 1) sum |x|."""
    rows = np.asarray(rows)
    valid = (rows >= 0) & (rows < height)      # padding ids point past it
    uniq, sums, abs_sums, n, first, second = segment_sums(
        rows[valid], np.asarray(values).reshape(len(rows), -1)[valid])
    out_rows = np.asarray(out_rows)
    out_values = np.asarray(out_values, np.float32).reshape(len(out_rows), -1)
    keep = (out_rows >= 0) & (out_rows < height)
    got_rows, got = out_rows[keep], out_values[keep]
    order = np.argsort(got_rows, kind="stable")
    got_rows, got = got_rows[order], got[order]
    rows_equal = bool(np.array_equal(got_rows, uniq))
    rec = {"contributions": int(valid.sum()), "unique_ids": int(len(uniq)),
           "longest_run": int(n.max(initial=0)), "rows_equal": rows_equal}
    if not rows_equal:
        rec.update(short_runs_exact=False, within_bound=False)
        return rec
    short = n <= 2
    want_short = first + second                   # f32: one rounding or none
    rec["short_runs"] = int(short.sum())
    # equal as values (an exact 0 may carry either sign)
    rec["short_runs_exact"] = bool(np.array_equal(got[short],
                                                  want_short[short]))
    k = (n - 1)[:, None]
    bound = (gamma(k) + gamma(k, U64)) * abs_sums + k * TINY
    ratio_max, err = ratio(got[~short], sums[~short], bound[~short])
    rec.update(max_abs_err=err, max_err_over_bound=ratio_max,
               within_bound=ratio_max <= 1.0)
    if (~short).any():
        # the run that comes nearest its bound: its length, and its sum's
        # magnitude against the sum of the magnitudes (1 where every term
        # has one sign, as in a run whose roundings can all align)
        q = np.abs(got[~short] - sums[~short]) / np.where(
            bound[~short] > 0, bound[~short], np.inf)
        i, j = np.unravel_index(np.argmax(q), q.shape)
        rec["worst_run"] = {"n": int(n[~short][i]), "sum_over_abs_sum": float(
            abs(sums[~short][i, j]) / max(abs_sums[~short][i, j], 1e-300))}
    return rec


def sparse_adam_reference(param, m1, m2, beta1_pow, beta2_pow, lr, rows,
                          grad, beta1=0.9, beta2=0.999, eps=1e-8,
                          lazy=False):
    """``{"ParamOut", "Moment1Out", "Moment2Out"}`` as ``Bounded`` values:
    the float64 recomputation of the port's sparse Adam rule
    (``ops/optimizer_ops.py`` ``_adam`` on a SelectedRows gradient) from
    its merged gradient (``rows`` [N] with the sentinel ``height`` where a
    slot holds no row, ``grad`` [N, D]) and the old state, operation by
    operation in the rule's order:

        lr_t = lr * sqrt(1 - beta2_pow) / (1 - beta1_pow)
        every row (unless lazy):  m = beta1 m;  v = beta2 v;
                                  p = p - lr_t m / (sqrt(v) + eps)
        merged rows:  m = beta1 m + (1 - beta1) g
                      v = beta2 v + (1 - beta2) (g g)
                      p = p - lr_t m / (sqrt(v) + eps)
    """
    B = Bounded
    height = param.shape[0]
    one = B(1.0, 0.0)                       # the integer 1: exact in f32
    lr_t = (B.exact(np.reshape(lr, ())) * (one - B.exact(
        np.reshape(beta2_pow, ()))).sqrt()) / (one - B.exact(
            np.reshape(beta1_pow, ())))
    c1, c2 = B.const(beta1), B.const(beta2)
    c1m, c2m, ce = B.const(1 - beta1), B.const(1 - beta2), B.const(eps)
    P, M, V = B.exact(param), B.exact(m1), B.exact(m2)
    if lazy:
        p_base, m_base, v_base = P, M, V
    else:
        m_base, v_base = c1 * M, c2 * V
        p_base = P - lr_t * m_base / (v_base.sqrt() + ce)
    rows = np.asarray(rows)
    if (rows < 0).any():
        raise ValueError("merged rows hold a negative id")
    keep = rows < height
    r = rows[keep]
    G = B.exact(np.asarray(grad, np.float32).reshape(len(rows), -1)[keep])
    m_rows = c1 * M.take(r) + c1m * G
    v_rows = c2 * V.take(r) + c2m * (G * G)
    p_rows = P.take(r) - lr_t * m_rows / (v_rows.sqrt() + ce)
    out = {}
    for name, base, upd in (("ParamOut", p_base, p_rows),
                            ("Moment1Out", m_base, m_rows),
                            ("Moment2Out", v_base, v_rows)):
        ref = np.array(np.broadcast_to(base.r, param.shape))
        err = np.array(np.broadcast_to(base.e, param.shape))
        ref[r], err[r] = upd.r, upd.e
        out[name] = B(ref, err)
    return out


def sparse_adam_f32(param, m1, m2, beta1_pow, beta2_pow, lr, rows, grad,
                    beta1=0.9, beta2=0.999, eps=1e-8, lazy=False):
    """The same rule replayed in numpy f32, operation by operation, with
    the constants rounded to f32 as PyTorch rounds a Python scalar that
    meets an f32 tensor: IEEE arithmetic gives the same bits as any other
    IEEE implementation of the same operations in the same order."""
    f = np.float32
    one = f(1)
    lr_t = (f(np.reshape(lr, ())) * np.sqrt(one - f(np.reshape(beta2_pow, ())))
            ) / (one - f(np.reshape(beta1_pow, ())))
    c1, c2, c1m, c2m, ce = (f(beta1), f(beta2), f(1 - beta1), f(1 - beta2),
                            f(eps))
    p, m, v = (np.asarray(a, f) for a in (param, m1, m2))
    if lazy:
        p_out, m_out, v_out = p.copy(), m.copy(), v.copy()
    else:
        m_out, v_out = c1 * m, c2 * v
        p_out = p - lr_t * m_out / (np.sqrt(v_out) + ce)
    rows = np.asarray(rows)
    keep = rows < p.shape[0]
    r = rows[keep]
    g = np.asarray(grad, f).reshape(len(rows), -1)[keep]
    m_r = c1 * m[r] + c1m * g
    v_r = c2 * v[r] + c2m * (g * g)
    p_out[r] = p[r] - lr_t * m_r / (np.sqrt(v_r) + ce)
    m_out[r], v_out[r] = m_r, v_r
    return {"ParamOut": p_out, "Moment1Out": m_out, "Moment2Out": v_out}


def sparse_adam_check(outs, **inputs):
    """``{name: {"max_abs_err", "max_err_over_bound", "within_bound",
    "f32_replay_equal"}}`` of one route's Adam outputs ``outs`` (numpy, by
    output slot) against ``sparse_adam_reference(**inputs)``, with whether
    they equal ``sparse_adam_f32(**inputs)`` value for value."""
    ref = sparse_adam_reference(**inputs)
    replay = sparse_adam_f32(**inputs)
    rec = {}
    for name, want in ref.items():
        r, err = ratio(outs[name], want.r, want.e)
        rec[name] = {"max_abs_err": err, "max_err_over_bound": r,
                     "within_bound": r <= 1.0,
                     "f32_replay_equal": bool(np.array_equal(
                         np.asarray(outs[name], np.float32), replay[name]))}
    return rec


def sparse_sgd_check(out, param, lr, rows, values):
    """Hold the sparse SGD rule's table (``param[rows] += -lr * values``
    added slot by slot, duplicates unmerged, by ``scatter_rows_drop``'s
    ``index_add_`` in any order) to its float64 recomputation: each product
    carries u |lr x| + 2^-149, and a row's n + 1 terms (the old value and
    its n products) sum within gamma(n) times their magnitudes, plus the
    float64 reference's gamma_64(n) of the same."""
    height = param.shape[0]
    rows = np.asarray(rows)
    keep = (rows >= 0) & (rows < height)
    if (rows < 0).any():
        raise ValueError("sparse rows hold a negative id")
    v = np.asarray(values, np.float32).reshape(len(rows), -1)[keep]
    prod = Bounded.exact(-np.reshape(lr, ())) * Bounded.exact(v)
    rr = rows[keep]
    ref = np.array(param, np.float64).reshape(height, -1)
    mag = np.abs(ref)
    prod_err = np.zeros_like(ref)
    n = np.zeros(height)
    np.add.at(ref, rr, prod.r)
    np.add.at(mag, rr, np.abs(prod.r) + prod.e)
    np.add.at(prod_err, rr, prod.e)
    np.add.at(n, rr, 1.0)
    k = n[:, None]
    bound = (gamma(k) + gamma(k + 1, U64)) * mag + prod_err + k * TINY
    r, err = ratio(np.asarray(out).reshape(height, -1), ref, bound)
    return {"ParamOut": {"max_abs_err": err, "max_err_over_bound": r,
                         "within_bound": r <= 1.0}}


@contextlib.contextmanager
def capture_sparse_updates():
    """Record, as numpy, every ``adam`` and ``sgd`` rule that meets a
    SelectedRows gradient inside the block: its inputs, attrs, gradient
    (rows, values), the merge it made (``sparse.merge_rows``'s inputs and
    outputs) and its outputs.  Yields the list, in run order.  The rules
    are wrapped in the registry, which an executor reads when it makes a
    plan: run a fresh ``Executor`` inside the block.  Its plan keeps the
    wrapped rules, which record nothing after the block."""
    import torch

    from .. import registry, sparse

    def np_(t):
        return t.detach().cpu().numpy().copy()

    records, current, on = [], [], [True]
    orig_merge = sparse.merge_rows
    orig_rules = {k: registry._OP_LOWERING[k] for k in ("adam", "sgd")}

    def merge(rows, values, height, via=None):
        out_rows, out_values = orig_merge(rows, values, height, via=via)
        if current:
            current[-1]["merge"] = (np_(rows), np_(values), np_(out_rows),
                                    np_(out_values), int(height))
        return out_rows, out_values

    def wrap(name, rule):
        def wrapped(ins, attrs, ctx):
            g = ins["Grad"][0]
            if not (on[0] and isinstance(g, sparse.SelectedRows)):
                return rule(ins, attrs, ctx)
            rec = {"op": name, "attrs": dict(attrs),
                   "ins": {k: np_(v[0]) for k, v in ins.items()
                           if k != "Grad" and isinstance(v[0], torch.Tensor)},
                   "grad": (np_(g.rows), np_(g.values), g.height)}
            current.append(rec)
            try:
                outs = rule(ins, attrs, ctx)
            finally:
                current.pop()
            rec["outs"] = {k: np_(v[0]) for k, v in outs.items()}
            records.append(rec)
            return outs

        return wrapped

    sparse.merge_rows = merge
    for k, rule in orig_rules.items():
        registry._OP_LOWERING[k] = wrap(k, rule)
    try:
        yield records
    finally:
        on[0] = False
        sparse.merge_rows = orig_merge
        registry._OP_LOWERING.update(orig_rules)


def check_sparse_update(rec, replay=False):
    """The checks of one captured sparse update: for ``adam`` the merge
    against the exact sums (``merge_check``) and the outputs against
    ``sparse_adam_reference`` from the merge's own result; for ``sgd`` the
    table against ``sparse_sgd_check``.  Returns a record whose ``ok``
    says whether every check held; with ``replay`` Adam's outputs must
    also equal the f32 replay (``sparse_adam_f32``), as they do wherever
    every operation is IEEE (the card's; the CPU's vectorised ``sqrt`` is
    not correctly rounded)."""
    ins, outs, attrs = rec["ins"], rec["outs"], rec["attrs"]
    rows, values, height = rec["grad"]
    if rec["op"] == "sgd":
        res = sparse_sgd_check(outs["ParamOut"], ins["Param"],
                               ins["LearningRate"], rows, values)
        ok = all(v["within_bound"] for v in res.values())
        return dict(op="sgd", height=height, ok=ok, **res)
    m_rows, m_vals = rec["merge"][2], rec["merge"][3]
    merge = merge_check(rows, values, m_rows, m_vals, height)
    res = sparse_adam_check(
        outs, param=ins["Param"], m1=ins["Moment1"], m2=ins["Moment2"],
        beta1_pow=ins["Beta1Pow"], beta2_pow=ins["Beta2Pow"],
        lr=ins["LearningRate"], rows=m_rows, grad=m_vals,
        beta1=attrs.get("beta1", 0.9), beta2=attrs.get("beta2", 0.999),
        eps=attrs.get("epsilon", 1e-8), lazy=attrs.get("lazy_mode", False))
    ok = (merge["rows_equal"] and merge["short_runs_exact"]
          and merge["within_bound"]
          and all(v["within_bound"] and (v["f32_replay_equal"] or not replay)
                  for v in res.values()))
    return dict(op="adam", height=height, ok=ok, merge=merge, **res)


# -- op rules, operation by operation (BoundMode) ------------------------------

# CUDA C++ Programming Guide, Mathematical Functions, the single-precision
# table: maximum ulp error of each function as compiled without
# -use_fast_math.  The IEEE-rounded operations (+ - * /, sqrt, 1/x) are
# within half an ulp and are not listed.
CUDA_ULPS = {"exp": 2, "expm1": 1, "log": 1, "log2": 1, "log10": 2,
             "log1p": 1, "sin": 2, "cos": 2, "tan": 4, "asin": 2, "acos": 2,
             "atan": 2, "sinh": 3, "cosh": 2, "tanh": 2, "erf": 2,
             "rsqrt": 2, "pow": 4}
_IEEE = ("add", "sub", "rsub", "mul", "div", "sqrt", "reciprocal",
         "remainder")
_SELECT = ("neg", "abs", "where", "maximum", "minimum", "clamp", "clamp_min",
           "clamp_max", "sgn", "sign", "masked_fill", "floor", "ceil",
           "round", "trunc", "relu", "floor_divide", "fmod")
_COMPARE = ("eq", "ne", "lt", "le", "gt", "ge")
_EXACT_NONFLOAT = ("isnan", "isinf", "isfinite", "logical_and", "logical_or",
                   "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
                   "bitwise_not", "any", "all", "argmax", "argmin")
_FRESH = ("arange", "full", "zeros", "ones", "eye", "scalar_tensor",
          "lift_fresh", "lift_fresh_copy", "ones_like", "zeros_like",
          "full_like", "empty_like", "new_zeros", "new_ones", "new_full",
          "new_empty", "empty", "linspace", "fill", "zero")
_LINEAR = ("view", "_unsafe_view", "reshape", "expand", "permute",
           "transpose", "t", "select", "slice", "squeeze", "unsqueeze",
           "unbind", "split", "split_with_sizes", "diagonal",
           "diagonal_copy", "diag_embed", "diag", "index", "index_select",
           "gather", "flip", "roll", "repeat", "cat", "stack",
           "constant_pad_nd", "reflection_pad2d", "replication_pad2d",
           "reflection_pad2d_backward", "replication_pad2d_backward",
           "slice_backward", "select_backward", "diagonal_backward",
           "index_put", "scatter", "scatter_add", "index_add", "clone",
           "contiguous", "detach", "alias", "_to_copy", "copy", "sum",
           "cumsum", "narrow", "_upsample_nearest_exact2d",
           "_upsample_nearest_exact2d_backward", "masked_scatter",
           "im2col", "col2im", "max_pool2d_with_indices_backward",
           "max_pool3d_with_indices_backward")
# window sums: linear only with divisor_override = 1 (the pooling rules'
# sums; a divisor would add a division's rounding)
_WINDOW_SUMS = ("avg_pool2d", "avg_pool3d", "avg_pool2d_backward",
                "avg_pool3d_backward")
_MULTILINEAR = ("mm", "bmm", "mv", "dot", "convolution",
                "convolution_backward")


def _g(k, u):
    return k * u / (1.0 - k * u)


def _own(y, ulps):
    """The bound of one operation's own rounding at exact result y: half
    an ulp (u |y|) for an IEEE-rounded one, ``ulps`` ulps (2u |y| each)
    for a library function, plus the float64 reference's rounding."""
    rel = U32 if ulps == 0 else 2.0 * U32 * ulps
    return (rel + 2.0 * U64) * y.abs() + max(ulps, 1) * TINY


def _f32_error(c):
    """The rounding of a constant to f32 (0 for one f32 holds exactly, an
    infinity or a NaN included)."""
    if isinstance(c, float):
        return abs(c - float(np.float32(c))) if math.isfinite(c) else 0.0
    return torch.where(torch.isfinite(c), (c - c.float().double()).abs(),
                       torch.zeros_like(c))


class _V:
    """A float64 reference value and a bound on the card's distance from
    it (tensors, or a Python float for a scalar operand)."""

    __slots__ = ("r", "e")

    def __init__(self, r, e):
        self.r, self.e = r, e

    @classmethod
    def const(cls, c):
        return cls(c, _f32_error(c))


def _finite_bound(y, e):
    """0 where the reference is NaN or infinite (the card must give the
    same there), inf where a corner left the function's domain."""
    e = torch.where(torch.isfinite(y), e, torch.zeros_like(e))
    return torch.nan_to_num(e, nan=float("inf"))


def _ew(fn, args, ulps):
    """y = fn(*args) elementwise; ``args`` hold ``_V`` operands and other
    arguments.  The operands' bounds go through fn at the corners of
    their intervals; ``ulps`` None adds no rounding (a selection), else
    ``_own``."""
    vals = [a.r if isinstance(a, _V) else a for a in args]
    y = fn(*vals)
    var = [i for i, a in enumerate(args) if isinstance(a, _V)
           and (a.e > 0 if isinstance(a.e, float) else bool((a.e > 0).any()))]
    dev = torch.zeros_like(y, dtype=torch.float64)
    for signs in itertools.product((-1.0, 1.0), repeat=len(var)):
        cv = list(vals)
        for i, sgn in zip(var, signs):
            cv[i] = args[i].r + sgn * args[i].e
        dev = torch.maximum(dev, (fn(*cv) - y).abs())
    if ulps is None:
        e = dev
    else:
        e = dev + _own(y.abs() + dev, ulps)
        if ulps == 0:
            # exact operands and a float64 result that f32 holds: the
            # card's correctly rounded result is that value itself
            e = torch.where((dev == 0) & (y == y.float().double()),
                            torch.zeros_like(e), e)
    return _V(y, _finite_bound(y, e))


def _vsum(v, dim, keepdim=True):
    """A sum over ``dim`` in any order: the terms' bounds plus
    gamma(n - 1) times the sum of their magnitudes."""
    r = v.r.sum(dim=dim, keepdim=keepdim)
    n = v.r.numel() // max(r.numel(), 1)
    mag = (v.r.abs() + v.e).sum(dim=dim, keepdim=keepdim)
    k = max(n - 1, 0)
    return _V(r, v.e.sum(dim=dim, keepdim=keepdim)
              + (_g(k, U32) + _g(k, U64)) * mag + k * TINY)


def _mul(a, b):
    return _ew(torch.mul, [a, b], 0)


def _add(a, b):
    return _ew(torch.add, [a, b], 0)


def _sub(a, b):
    return _ew(torch.sub, [a, b], 0)


def _div(a, b):
    return _ew(torch.div, [a, b], 0)


def _fn(name, a):
    return _ew(getattr(torch, name), [a], CUDA_ULPS.get(name, 0))


def _c(x):
    return _V.const(float(x))


def _tree_map_3(fn, a, b, c):
    la, spec = tree_flatten(a)
    return tree_unflatten([fn(x, y, z) for x, y, z in zip(
        la, tree_flatten(b)[0], tree_flatten(c)[0])], spec)


class BoundMode(TorchDispatchMode):
    """Runs a rule in float64 on the CPU and keeps, beside every
    tensor, a bound on the distance of the card's f32 value from it
    (see the module's docstring).  ``set_exact(t)`` marks an input;
    ``bound(t)`` reads a bound; ``ambiguous`` lists the comparisons
    the bounds could not decide."""

    def __init__(self):
        super().__init__()
        self._bounds = {}
        self.ambiguous = []

    @staticmethod
    def _key(t):
        return (t.untyped_storage().data_ptr(), t.storage_offset(),
                tuple(t.shape), tuple(t.stride()), t.dtype)

    def set(self, t, e):
        # the tensor is kept alive, so its storage is not reused while
        # the entry stands
        self._bounds[self._key(t)] = (t, e.expand(t.shape).clone())

    def set_exact(self, t):
        self.set(t, torch.zeros_like(t))

    def bound(self, t):
        hit = self._bounds.get(self._key(t))
        if hit is not None:
            return hit[1]
        return _finite_bound(t, _f32_error(t))

    # -- helpers ------------------------------------------------------

    def _v(self, a):
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return _V(a, self.bound(a))
        if isinstance(a, float):
            return _V.const(a)
        return a

    def _sub_args(self, args, kwargs, fn):
        """args with every float tensor t replaced by fn(t) and float
        scalars by 0 (a pad value, which must be exact in f32)."""
        def one(a):
            if isinstance(a, torch.Tensor) and a.is_floating_point():
                return fn(a)
            if isinstance(a, float):
                if _f32_error(a) != 0.0:
                    raise NotImplementedError(
                        "a linear op's constant %r is not exact in f32" % a)
                return 0.0
            return a
        return tree_map(one, args), tree_map(one, kwargs)

    def _runner(self, func, args, kwargs):
        def run(fn):
            a, k = self._sub_args(args, kwargs, fn)
            return func(*a, **k)
        return run

    def _floats_in(self, args, kwargs):
        leaves, _ = tree_flatten((args, kwargs))
        return [t for t in leaves if isinstance(t, torch.Tensor)
                and t.is_floating_point()]

    def _set_tree(self, out, bounds):
        for o, e in zip(tree_flatten(out)[0], tree_flatten(bounds)[0]):
            if isinstance(o, torch.Tensor) and o.is_floating_point():
                self.set(o, _finite_bound(o, e))

    def _fresh(self, out):
        for o in tree_flatten(out)[0]:
            if isinstance(o, torch.Tensor) and o.is_floating_point():
                self.set(o, _finite_bound(o, _f32_error(o)))

    # -- the families of ops --------------------------------------------

    def _linear(self, func, args, kwargs, out):
        if not self._floats_in(args, kwargs):
            return self._fresh(out)
        run = self._runner(func, args, kwargs)
        prop = run(self.bound)
        cnt = run(torch.ones_like)
        mag = run(lambda t: t.abs() + self.bound(t))

        def bound(p, n, m):
            if not isinstance(p, torch.Tensor) or not p.is_floating_point():
                return p
            k = (n - 1).clamp_min(0)
            return p + (_g(k, U32) + _g(k, U64)) * m + k * TINY

        self._set_tree(out, _tree_map_3(bound, prop, cnt, mag))

    def _multilinear(self, func, args, kwargs, out):
        run = self._runner(func, args, kwargs)
        mag = run(torch.abs)
        mag_e = run(lambda t: t.abs() + self.bound(t))
        cnt = run(torch.ones_like)

        def bound(m, me, n):
            if not isinstance(m, torch.Tensor):
                return m
            return ((me - m).clamp_min(0) + (_g(n, U32) + _g(n, U64)) * me
                    + n * TINY)

        self._set_tree(out, _tree_map_3(bound, mag, mag_e, cnt))

    def _compare(self, func, args, kwargs, out):
        a, b = (self._v(x) for x in args[:2])
        if not (isinstance(a, _V) and isinstance(b, _V)):
            return
        diff = (torch.as_tensor(a.r, dtype=torch.float64)
                - torch.as_tensor(b.r, dtype=torch.float64)).abs()
        near = (diff > 0) & (diff <= torch.as_tensor(a.e) + torch.as_tensor(b.e))
        if bool(near.any()):
            self.ambiguous.append(str(func))

    def _elementwise(self, func, args, kwargs, ulps):
        vs = [self._v(a) for a in args]
        return _ew(lambda *xs: func(*xs, **kwargs), vs, ulps)

    def _ulps(self, name, args):
        if name in _IEEE:
            return 0
        if name in _SELECT:
            return None
        if name == "pow":
            p = args[1]
            if isinstance(p, (int, float)) and float(p) in (
                    0.0, 1.0, 2.0, 0.5, -1.0):
                return 0
            return CUDA_ULPS["pow"]
        return CUDA_ULPS.get(name)

    # -- fused kernels, taken apart as their CUDA code computes -------

    def _composite(self, name, func, args, kwargs):
        V = self._v
        if name == "sigmoid":            # 1 / (1 + exp(-x))
            return _div(_c(1), _add(_c(1), _fn("exp", _ew(
                torch.neg, [V(args[0])], None))))
        if name == "sigmoid_backward":   # g (1 - y) y
            g, y = V(args[0]), V(args[1])
            return _mul(_mul(g, _sub(_c(1), y)), y)
        if name == "tanh_backward":      # g (1 - y y)
            g, y = V(args[0]), V(args[1])
            return _mul(g, _sub(_c(1), _mul(y, y)))
        if name == "logaddexp":          # max + log1p(exp(-|a - b|))
            a, b = V(args[0]), V(args[1])
            m = _ew(torch.maximum, [a, b], None)
            d = _ew(torch.abs, [_sub(a, b)], None)
            return _add(m, _fn("log1p", _fn("exp", _ew(torch.neg, [d], None))))
        if name == "log_sigmoid_forward":  # min(x, 0) - log1p(exp(-|x|))
            x = V(args[0])
            z = _fn("exp", _ew(torch.neg, [_ew(torch.abs, [x], None)], None))
            m = _ew(lambda t: t.clamp_max(0.0), [x], None)
            return _sub(m, _fn("log1p", z))
        if name == "log_sigmoid_backward":
            # g (max_deriv - sign z / (1 + z)), z = exp(-|x|)
            g, x = V(args[0]), V(args[1])
            z = _fn("exp", _ew(torch.neg, [_ew(torch.abs, [x], None)], None))
            q = _div(z, _add(_c(1), z))
            neg = x.r < 0
            t = _ew(lambda qq: torch.where(neg, 1.0 - qq, qq), [q], 0)
            return _mul(g, t)
        if name == "gelu":
            x = V(args[0])
            if kwargs.get("approximate", "none") == "tanh":
                # 0.5 x (1 + tanh(beta (x + kappa x^3)))
                beta = math.sqrt(2.0) * (2.0 / math.sqrt(math.pi)) * 0.5
                cube = _mul(_mul(x, x), x)
                inner = _mul(_c(beta), _add(x, _mul(_c(0.044715), cube)))
                return _mul(_mul(_c(0.5), x), _add(_c(1), _fn("tanh", inner)))
            # x 0.5 (1 + erf(x / sqrt 2))
            t = _fn("erf", _mul(x, _c(math.sqrt(0.5))))
            return _mul(_mul(x, _c(0.5)), _add(_c(1), t))
        if name == "gelu_backward":
            g, x = V(args[0]), V(args[1])
            if kwargs.get("approximate", "none") == "tanh":
                beta = math.sqrt(2.0) * (2.0 / math.sqrt(math.pi)) * 0.5
                kappa = 0.044715
                sq = _mul(x, x)
                inner = _mul(_c(beta), _add(x, _mul(_c(kappa), _mul(sq, x))))
                th = _fn("tanh", inner)
                left = _mul(_c(0.5), x)
                right = _add(_c(1), th)
                dleft = _mul(_c(0.5), right)
                dth = _sub(_c(1), _mul(th, th))
                dinner = _mul(_c(beta), _add(_c(1), _mul(_c(3 * kappa), sq)))
                dright = _mul(_mul(left, dth), dinner)
                return _mul(g, _add(dleft, dright))
            # cdf + x pdf, cdf = 0.5 (1 + erf(x / sqrt 2)),
            # pdf = exp(-0.5 x x) / sqrt(2 pi)
            cdf = _mul(_c(0.5), _add(_c(1), _fn("erf", _mul(x, _c(math.sqrt(0.5))))))
            pdf = _mul(_fn("exp", _mul(_mul(_c(-0.5), x), x)),
                       _c(1.0 / math.sqrt(2.0 * math.pi)))
            return _mul(g, _add(cdf, _mul(x, pdf)))
        if name == "_softmax_backward_data":   # y (g - sum g y)
            g, y, dim = V(args[0]), V(args[1]), args[2]
            s = _vsum(_mul(g, y), dim)
            return _mul(y, _sub(g, s))
        if name == "_log_softmax_backward_data":  # g - exp(y) sum g
            g, y, dim = V(args[0]), V(args[1]), args[2]
            return _sub(g, _mul(_fn("exp", y), _vsum(g, dim)))
        if name == "linalg_vector_norm":
            return self._vector_norm(args, kwargs)
        raise KeyError(name)

    def _softmax(self, args, log):
        """y = exp(x - m) / S or (x - m) - log S, S = sum exp(x - m):
        the input's bounds move y by at most y (e^{e_i} / sum_j y_j
        e^{-e_j} - 1) (log: e_i + log sum_j y_j e^{e_j}); the card's
        x - m rounds by u |x - m|, exp by 2 ulps, the sum by
        gamma(n - 1), the division or subtraction by half an ulp."""
        x, dim = self._v(args[0]), args[1]
        n = x.r.shape[dim] if x.r.ndim else 1
        z = x.r - x.r.amax(dim=dim, keepdim=True)
        p = torch.softmax(x.r, dim=dim)
        rho = U32 * z.abs() + 2.0 * CUDA_ULPS["exp"] * U32 + 2.0 * U64
        rho_s = (p * rho).sum(dim=dim, keepdim=True) + _g(max(n - 1, 0), U32)
        if log:
            y = torch.log_softmax(x.r, dim=dim)
            prop = x.e + torch.log((p * torch.exp(x.e)).sum(dim=dim, keepdim=True))
            log_s = (y - z).abs()
            own = (U32 * z.abs() + rho_s / (1.0 - rho_s)
                   + 2.0 * CUDA_ULPS["log"] * U32 * log_s
                   + U32 * (y.abs() + rho_s + log_s) + 2.0 * U64 * y.abs())
            return _V(y, _finite_bound(y, (prop + own) * (1.0 + 1e-6) + 4 * TINY))
        y = p
        up = torch.exp(x.e) / (p * torch.exp(-x.e)).sum(dim=dim, keepdim=True) - 1.0
        down = 1.0 - torch.exp(-x.e) / (p * torch.exp(x.e)).sum(dim=dim, keepdim=True)
        prop = y * torch.maximum(up, down)
        own = y * (rho + rho_s + 2.0 * U32) * (1.0 + 1e-6)
        return _V(y, _finite_bound(y, prop + own + 4 * TINY))

    def _vector_norm(self, args, kwargs):
        """sum |x|^p then ^(1/p), as the CUDA norm kernels: p = 2 as
        sqrt(sum x x), 1 as sum |x|, inf as max |x|."""
        x = self._v(args[0])
        ord_ = float(args[1]) if len(args) > 1 else 2.0
        dim = args[2] if len(args) > 2 else kwargs.get("dim")
        keep = args[3] if len(args) > 3 else kwargs.get("keepdim", False)
        dims = tuple(range(x.r.ndim)) if dim is None or dim == [] else (
            tuple(dim) if isinstance(dim, (list, tuple)) else (dim,))
        a = _ew(torch.abs, [x], None)
        if ord_ == float("inf"):
            return _V(a.r.amax(dim=dims, keepdim=keep),
                      a.e.amax(dim=dims, keepdim=keep))
        if ord_ == 1.0:
            return _vsum(a, dims, keep)
        if ord_ == 2.0:
            return _fn("sqrt", _vsum(_mul(a, a), dims, keep))
        s = _vsum(_ew(torch.pow, [a, _c(ord_)], CUDA_ULPS["pow"]), dims, keep)
        return _ew(torch.pow, [s, _c(1.0 / ord_)], CUDA_ULPS["pow"])

    def _svd(self, out, args):
        """A backward stable SVD computes the singular values of A + E
        (LAPACK Users' Guide, 4.9); the Householder reductions it rests
        on keep ||E||_F <= c m n u ||A||_F (Higham, Accuracy and
        Stability, Theorem 19.4, applied on the left and on the right:
        c = 2 taken, the theorem's constant being unstated).  Weyl: each
        singular value moves by at most ||E||, and the i-th singular
        vectors turn by at most ||E|| / gap_i (Wedin), so a vector entry
        moves by at most that angle (and never more than 2).  Signs: U
        and V flip together, which u_i v_i^T does not see."""
        U, S, Vh = out
        m, n = args[0].shape[-2:]
        fro = args[0].square().sum(dim=(-2, -1)).sqrt().unsqueeze(-1)
        tol = 2.0 * m * n * U32 * fro
        self.set(S, tol.expand(S.shape) + 2.0 * U64 * S.abs())
        if U.numel() == 0:
            return
        gaps = (S.unsqueeze(-1) - S.unsqueeze(-2)).abs()
        gaps = gaps + torch.diag_embed(torch.full_like(S, float("inf")))
        gap = gaps.amin(dim=-1)
        if m != n:
            gap = torch.minimum(gap, S)
        theta = (tol / gap).clamp(max=2.0)
        k = S.shape[-1]
        self.set(U, torch.nn.functional.pad(
            theta, (0, U.shape[-1] - k), value=2.0).unsqueeze(-2).expand(U.shape))
        self.set(Vh, torch.nn.functional.pad(
            theta, (0, Vh.shape[-2] - k), value=2.0).unsqueeze(-1).expand(Vh.shape))

    def _upsample_aa(self, name, func, args, kwargs, out):
        """Nonnegative weights w, sum w = 1 per output, on CUDA each a
        few roundings of (1 - |t|) normalised by their sum: the output
        moves by op(e), rounds as a sum of K terms, and each weight is
        off by at most (5 taps + 2) u."""
        if name.endswith("_backward"):
            g = args[0]
            (ho, wo), (hi, wi) = args[1], args[2][2:]
        else:
            g = args[0]
            hi, wi = g.shape[-2:]
            ho, wo = args[1]
        axes = [(hi, ho), (wi, wo)]
        taps = [math.ceil(2 * max(a / b, 1.0)) + 1 for a, b in axes]
        per_in = [math.ceil(2 * max(a / b, 1.0) / (a / b)) + 1 for a, b in axes]
        k = taps[0] * taps[1] if not name.endswith("_backward") else (
            per_in[0] * per_in[1] + 2)
        w_err = sum(5 * t + 2 for t in taps) * U32
        run = self._runner(func, args, kwargs)
        prop = run(self.bound)
        mag = run(lambda t: t.abs() + self.bound(t))
        big = float((g.abs() + self.bound(g)).amax()) if g.numel() else 0.0
        e = (prop + (_g(k, U32) + _g(k, U64)) * mag + w_err * k * big
             + k * TINY)
        self.set(out, _finite_bound(out, e))

    # -- dispatch -------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if kwargs.get("dtype") in (torch.float32, torch.float16,
                                   torch.bfloat16):
            kwargs["dtype"] = torch.float64
        args = tree_map(lambda a: a.double() if isinstance(a, torch.Tensor)
                        and a.dtype in (torch.float32, torch.float16,
                                        torch.bfloat16) else a, args)
        name = func.overloadpacket.__name__
        inplace = name.endswith("_") and not name.startswith("_")
        base = name[:-1] if inplace else name
        outplace = func
        if inplace:
            # pow_.Scalar takes a tensor to a scalar power: pow.Tensor_Scalar
            over = {"Scalar": "Tensor_Scalar", "Tensor": "Tensor_Tensor"}.get(
                func._overloadname) if base == "pow" else func._overloadname
            outplace = getattr(getattr(torch.ops.aten, base), over)
        out = func(*args, **kwargs)
        res = out if not inplace else args[0]
        floats_out = [o for o in tree_flatten(res)[0]
                      if isinstance(o, torch.Tensor) and o.is_floating_point()]
        if (floats_out and not inplace and (base in _IEEE or base in CUDA_ULPS)
                and not any(isinstance(a, torch.Tensor) and a.is_floating_point()
                            for a in tree_flatten(args)[0])):
            # integer or bool operands promoted to a float result (a true
            # division of integers, an integer times a Python float): the
            # run converts them to f32 first (exact below 2^24), so the
            # reference takes them in float64 and the operation's own
            # rounding gets its bound below
            args = tree_map(lambda a: a.double() if isinstance(a, torch.Tensor)
                            else a, args)
            out = res = func(*args, **kwargs)
            floats_out = [o for o in tree_flatten(res)[0]
                          if isinstance(o, torch.Tensor) and o.is_floating_point()]
        if base in _COMPARE:
            self._compare(func, args, kwargs, out)
        elif base in _FRESH:
            self._fresh(res)
        elif base in _EXACT_NONFLOAT and not floats_out:
            pass
        elif base in ("_to_copy", "copy") and not floats_out:
            x = args[0] if base == "_to_copy" else args[1]
            if x.is_floating_point():
                e = self.bound(x)
                if bool(((x + e).trunc() != (x - e).trunc()).any()):
                    self.ambiguous.append(str(func))
        elif base in _LINEAR:
            if base == "copy":            # copy_(dst, src)
                self.set(res, self.bound(args[1]).expand(res.shape))
            elif (base in ("view", "_unsafe_view")
                  and func._overloadname != "dtype"):
                # the bounds are stored contiguous, where a view of a
                # strided tensor may not exist: the same values by reshape
                self._linear(torch.ops.aten.reshape.default, args, kwargs, res)
            else:
                self._linear(outplace, args, kwargs, res)
        elif base in _MULTILINEAR:
            self._multilinear(func, args, kwargs, out)
        elif base in _WINDOW_SUMS:
            divisor = args[7 if base.endswith("_backward") else 6] if len(
                args) > (7 if base.endswith("_backward") else 6) else None
            if divisor != 1:
                raise NotImplementedError(
                    "no bound rule for %s without divisor_override=1" % func)
            self._linear(outplace, args, kwargs, res)
        elif base in ("max_pool2d_with_indices", "max_pool3d_with_indices"):
            # a selection: each output moves by at most the largest bound
            # in its window (the padding, -inf, takes no part)
            self.set(out[0], func(self.bound(args[0]), *args[1:], **kwargs)[0])
        elif base == "cummin":
            # a running selection: by at most the running largest bound
            self.set(out[0], torch.cummax(self.bound(args[0]), args[1])[0])
        elif base == "threshold_backward":
            # g where x > threshold, else 0: where x's interval holds the
            # threshold either may be the card's, so |g| + its bound
            g, xv, thr = self._v(args[0]), self._v(args[1]), args[2]
            flip = (xv.r - thr).abs() <= xv.e
            if bool((flip & (xv.r != thr)).any()):
                self.ambiguous.append(str(func))
            e = torch.where(flip, g.r.abs() + g.e,
                            torch.where(xv.r <= thr, torch.zeros_like(g.e), g.e))
            self.set(out, e)
        elif base in ("amax", "amin") and args[0].is_floating_point():
            # a selection: the result moves by at most the largest bound
            self.set(out, torch.ops.aten.amax.default(
                self.bound(args[0]), *args[1:], **kwargs))
        elif base == "mean":
            x = self._v(args[0])
            dims = args[1] if len(args) > 1 else kwargs.get("dim")
            keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
            dims = tuple(range(x.r.ndim)) if not dims else tuple(dims)
            s = _vsum(x, dims, keep)
            n = x.r.numel() // max(out.numel(), 1)
            v = _div(s, _c(float(n)))
            self.set(out, v.e)
        elif base == "sort" and args[0].is_floating_point():
            vals, idx = out
            dim = args[1] if len(args) > 1 else kwargs.get("dim", -1)
            e = self.bound(args[0])
            if bool((e > 0).any()):
                self.ambiguous.append(str(func))
            self.set(vals, torch.gather(e, dim, idx))
        elif base in ("_softmax", "_log_softmax"):
            self.set(out, self._softmax(args, base == "_log_softmax").e)
        elif base == "_linalg_svd":
            self._svd(out, args)
        elif base in ("_upsample_bilinear2d_aa",
                      "_upsample_bilinear2d_aa_backward"):
            self._upsample_aa(base, func, args, kwargs, out)
        elif base in ("sigmoid", "sigmoid_backward", "tanh_backward",
                      "logaddexp", "log_sigmoid_forward",
                      "log_sigmoid_backward", "gelu", "gelu_backward",
                      "_softmax_backward_data",
                      "_log_softmax_backward_data", "linalg_vector_norm"):
            v = self._composite(base, func, args, kwargs)
            first = out[0] if isinstance(out, tuple) else out
            self.set(first, v.e)
            if isinstance(out, tuple):
                self._fresh(out[1:])
        elif (base == "div" and floats_out and len(args) == 2 and not kwargs
              and isinstance(args[1], (int, float)) and args[1] != 0):
            # CUDA divides by a host scalar as a product with its f32
            # reciprocal (BinaryDivTrueKernel.cu): two roundings
            b = float(args[1])
            r32 = float(np.float32(1.0) / np.float32(b))
            v = _ew(torch.mul, [self._v(args[0]), _V(1.0 / b, abs(r32 - 1.0 / b))], 0)
            self.set(res, v.e.expand(res.shape))
        elif base in _IEEE or base in _SELECT or base in CUDA_ULPS:
            if floats_out:
                v = self._elementwise(outplace, args, kwargs,
                                      self._ulps(base, args))
                self.set(res, v.e.expand(res.shape))
        elif floats_out:
            raise NotImplementedError("no bound rule for %s" % func)
        return out


def rule_bounds(rule, ins, attrs, grad_slots=(), grad_out=None, cotangent=None):
    """Run op rule ``rule`` on float64 CPU copies of ``ins`` ({slot:
    [tensor]}; float inputs are f32 values, exact) under ``BoundMode``.
    Returns ``(outs, grads, ambiguous)``: {slot: [(reference, bound)]} of
    every output (bound None for a non-float one), the
    ``(reference, bound)`` of the gradient of <cotangent, outs[grad_out][0]>
    into each of ``grad_slots`` (None where it does not reach), and the
    comparisons the bounds could not decide."""
    from ..registry import OpLoweringContext

    mode = BoundMode()
    ctx = OpLoweringContext(None, torch.Generator().manual_seed(0))
    leaves = {}
    t_ins = {}
    for slot, vals in ins.items():
        t_ins[slot] = []
        for v in vals:
            v = v.detach().cpu()
            if v.is_floating_point():
                v = v.double()
                if slot in grad_slots and not t_ins[slot]:
                    v.requires_grad_(True)
                    leaves[slot] = v
            t_ins[slot].append(v)
    with mode:
        for vals in t_ins.values():
            for v in vals:
                if v.is_floating_point():
                    mode.set_exact(v.detach())
        outs = rule(t_ins, dict(attrs), ctx)
        res = {slot: [(o.detach(), mode.bound(o).detach()
                       if o.is_floating_point() else None) for o in vals]
               for slot, vals in outs.items()}
        grads = {}
        if grad_slots:
            y = outs[grad_out][0]
            ct = cotangent.detach().cpu().double()
            mode.set_exact(ct)
            got = torch.autograd.grad(y, [leaves[s] for s in grad_slots], ct,
                                      allow_unused=True)
            for slot, g in zip(grad_slots, got):
                grads[slot] = None if g is None else (g.detach(),
                                                      mode.bound(g).detach())
    return res, grads, mode.ambiguous


def hold_to_bound(got, ref, bound, exact=None):
    """Hold one output of a rule on the card (``got``) to its float64
    reference within ``rule_bounds``' bound: where the bound is 0 (no
    rounding anywhere on the way) ``got`` must equal ``exact`` (the CPU's
    f32 rule; ``ref`` when None) bit for bit, NaN matching NaN; elsewhere
    |got - ref| <= bound.  A non-float output (bound None) must equal
    ``exact`` exactly.  Returns {"ratio" (the largest error over bound),
    "max_abs_err", "exact_elements", "exact_mismatches", "ok"}."""
    got = got.detach().cpu()
    want = (ref if exact is None else exact).detach().cpu()
    if bound is None:
        same = got.shape == want.shape and bool(torch.equal(got, want.to(got.dtype)))
        return {"ratio": 0.0, "max_abs_err": 0.0, "exact_elements": got.numel(),
                "exact_mismatches": 0 if same else got.numel(), "ok": same}
    got, want, ref = got.double(), want.double(), ref.detach().cpu()
    if got.shape != ref.shape:
        return {"ratio": float("inf"), "max_abs_err": float("inf"),
                "exact_elements": 0, "exact_mismatches": got.numel(), "ok": False}
    zero = bound == 0
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    mismatches = int((zero & ~same).sum())
    err = (got - ref).abs()
    err = torch.where(zero | torch.isnan(err), torch.zeros_like(err), err)
    r = torch.where(zero, torch.zeros_like(err), err / bound)
    nan_off = int((~zero & (torch.isnan(got) != torch.isnan(ref))).sum())
    ratio = float(r.max()) if r.numel() else 0.0
    return {"ratio": ratio, "max_abs_err": float(err.max()) if err.numel() else 0.0,
            "exact_elements": int(zero.sum()),
            "exact_mismatches": mismatches + nan_off,
            "ok": ratio <= 1.0 and mismatches + nan_off == 0}
