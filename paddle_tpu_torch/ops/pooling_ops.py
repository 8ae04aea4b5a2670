"""Pooling window arithmetic (the helpers of ``paddle_tpu/ops/pooling_ops.py``
that ``pool2d`` and ``layers.pool2d`` use; its pool3d, with-index, maxout,
unpool and spp rules wait)."""


def pool_out_size(size, k, s, p, ceil_mode):
    """pool_op.cc PoolOutputSize: floor or ceil division of the window walk."""
    num = size + 2 * p - k
    return (num + s - 1) // s + 1 if ceil_mode else num // s + 1


def ceil_pads(size, k, s, p, ceil_mode):
    """(lo, hi) spatial pads; ceil_mode adds the extra high-side padding the
    reference's ceil output shape implies (pool_op.cc ceil_mode)."""
    if not ceil_mode:
        return (p, p)
    o = pool_out_size(size, k, s, p, True)
    extra = max((o - 1) * s + k - (size + 2 * p), 0)
    return (p, p + extra)
