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
"""

import contextlib

import numpy as np

__all__ = ["U32", "U64", "UNIT", "TINY", "gamma", "Bounded",
           "segment_sums", "merge_check", "ratio", "sparse_adam_reference",
           "sparse_adam_check", "sparse_sgd_check", "capture_sparse_updates",
           "check_sparse_update"]

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
