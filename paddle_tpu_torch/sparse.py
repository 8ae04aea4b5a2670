"""SelectedRows: sparse gradient semantics (counterpart of
``paddle_tpu/sparse.py``).

Parity: framework/selected_rows.h:32 (rows + value tensor + height) and
math/selected_rows_functor.cc MergeAdd.  An embedding gradient is a
``(rows, values)`` pair taken by differentiating with respect to the gathered
rows, so the ``[V, D]`` dense gradient never exists.  Duplicate ids are
merged without dynamic shapes, in one of two layouts:

- ``via="xla"`` (the default): the reference's XLA lowering in plain
  PyTorch ops — stable sort, first-of-run mask, cumsum, ``index_add_``.
  Unique rows are compacted to the front in sorted order.
- ``via="kernel"``: the segment-sum kernel (``kernels/segment_update.py``).
  Each unique row's total stays at its first sorted position.

``PADDLE_TPU_SEGMENT_KERNEL=1`` flips the default to the kernel.
"""

import os

import torch

__all__ = ["SelectedRows", "merge_rows"]


class SelectedRows:
    """A sparse slice of a [height, D] tensor: values[i] belongs to row
    rows[i].  rows may contain duplicates (summed on apply), matching
    selected_rows.h semantics."""

    def __init__(self, rows, values, height):
        self.rows = rows          # [N] int
        self.values = values      # [N, ...] same trailing dims as the param
        self.height = int(height)

    def merged(self):
        """(unique_rows_with_oob_sentinel, summed_values): duplicate rows
        summed, invalid slots pointed at row `height` so drop-mode scatters
        ignore them."""
        return merge_rows(self.rows, self.values, self.height)


def merge_rows(rows, values, height, via=None):
    """Sum values of duplicate rows without dynamic shapes.

    Returns (out_rows [N], out_values [N, ...]) where each unique input row
    appears exactly once with its values summed; the remaining slots have
    out_rows == height (out of bounds) and must be applied in drop mode.
    ``via``: "xla" (compacted, sorted unique rows) or "kernel" (unique rows
    at their first sorted position; not compacted, so a caller that relies
    on sorted rows must stay on "xla")."""
    if via is None:
        via = ("kernel" if os.environ.get("PADDLE_TPU_SEGMENT_KERNEL") == "1"
               else "xla")
    if via == "kernel":
        from .kernels.segment_update import dedup_segment_sum

        return dedup_segment_sum(rows, values, height)
    if via != "xla":
        raise ValueError("merge_rows: unknown via=%r (valid: 'xla', "
                         "'kernel')" % (via,))
    n = rows.shape[0]
    r, order = torch.sort(rows, stable=True)
    v = values[order]
    first = torch.ones(n, dtype=torch.bool, device=rows.device)
    first[1:] = r[1:] != r[:-1]
    seg = torch.cumsum(first, 0) - 1                 # unique index per pos
    summed = torch.zeros_like(v).index_add_(0, seg, v)
    out_rows = torch.full_like(r, height).scatter_(0, seg, r)
    return out_rows, summed
