"""GPipe-style pipeline parallelism (counterpart of
``paddle_tpu/parallel/pipeline.py``).

Every pp rank runs the same code on its stage's slice of the stacked layer
parameters; microbatch activations hop stage to stage with
``collectives.ppermute_shift`` over T = M + S - 1 ticks.  As in the
reference, every rank runs its stage at every tick, the bubble ticks
included (stage s computes on zeros or a stale input until microbatch 0
reaches it, and after the last one has passed), and the outputs of those
ticks are discarded.  The backward needs no scheduler: autograd runs the
ticks in reverse and each shift's backward is the opposite shift, which is
GPipe's backward phase.
"""

import torch

from . import collectives as col
from .mesh import PP

__all__ = ["gpipe", "split_microbatches"]


def split_microbatches(x, n_microbatches):
    """[B, ...] -> [M, B/M, ...]."""
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError("batch %d does not split into %d microbatches"
                         % (B, n_microbatches))
    return x.reshape((n_microbatches, B // n_microbatches)
                     + tuple(x.shape[1:]))


def gpipe(stage_fn, stage_params, x_mb, axis=PP):
    """Run the pipeline on this rank.

    stage_fn(stage_params, x) -> y with y.shape == x.shape (a stage-uniform
    activation shape).  x_mb: [M, mb, ...] microbatch inputs (stage 0
    reads them).  Returns [M, mb, ...]: the last stage's outputs, valid on
    the LAST pp rank (the others hold values the caller masks)."""
    M = x_mb.shape[0]
    S = col.axis_size_in(axis)
    first = torch.tensor(col.axis_index(axis) == 0, device=x_mb.device)
    T = M + S - 1
    recv = torch.zeros_like(x_mb[0])
    ys = []
    for t in range(T):
        # a where, not an if: every rank's graph holds the shifted input,
        # so every rank runs each shift's backward
        inp = torch.where(first, x_mb[min(t, M - 1)], recv)
        y = stage_fn(stage_params, inp)
        ys.append(y)
        if t < T - 1:        # the last tick's shift is read by no tick
            recv = col.ppermute_shift(y, axis, 1)
    # at tick t the last stage emits microbatch t - (S - 1)
    return torch.stack(ys[S - 1:])
