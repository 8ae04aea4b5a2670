"""Deduplicated segment sum of sparse row gradients: a CUDA kernel.

Counterpart of ``paddle_tpu/kernels/segment_update.py`` (Pallas
``_segsum_kernel`` and its wrapper ``dedup_segment_sum``).  Parity target:
PSLib's deduplicated sparse push and math/selected_rows_functor.cc MergeAdd.

``dedup_segment_sum(rows, values, height)`` sorts the ids once with a stable
``torch.sort`` (outside the kernel, as ``jnp.argsort`` is in JAX), then the
kernel sums the values of each run of equal ids.  The layout is the
reference's: each unique id's total lands at its run's FIRST sorted position,
every other slot holds zeros and the row id ``height`` (the drop sentinel);
ids outside ``[0, height)`` keep their id.  Unlike ``sparse.merge_rows(via=
"xla")`` the unique rows are not compacted to the front.  The result applies
as one scatter per unique row (``apply_rows_update``).

The kernel (``csrc/segment_update.cu``, one launch a call) reads the values
through the sort's permutation, so the sorted copy of the values is never
written, and sums in f32 whatever the values' dtype; runs that cross its
tiles are added by the last of each run's tiles to finish, in a fixed order,
so two calls give the same bits.  On a CPU tensor the wrappers run the plain
PyTorch version below; on a CUDA tensor they launch the kernel or raise.
"""

import torch

from . import _common

__all__ = ["dedup_segment_sum", "apply_rows_update", "segsum_plain",
           "scatter_rows_drop"]

_TILE = 256     # sorted positions per block (csrc/segment_update.cu kTile)
_COLS = 32      # columns per block (kCols): wider rows take several blocks
_WORK = {}      # (device index, stream) -> (scratch f32, run counters int32)


def segsum_plain(rows, values, height):
    """The plain version: stable sort, first-of-run mask, f32 run totals by
    ``index_add_`` into the runs' compact slots, then read back at the
    first positions.  Same outputs as the kernel."""
    n = rows.shape[0]
    keys, order = torch.sort(rows, stable=True)
    v = values.reshape(n, -1)[order].float()
    first = torch.ones(n, dtype=torch.bool, device=rows.device)
    first[1:] = keys[1:] != keys[:-1]
    seg = torch.cumsum(first, 0) - 1
    sums = torch.zeros_like(v).index_add_(0, seg, v)
    out = torch.where(first[:, None], sums[seg], 0.0).to(values.dtype)
    out_rows = torch.where(first, keys, torch.full_like(keys, height))
    return out_rows, out.reshape(values.shape)


def _check(rows, values):
    if rows.device != values.device:
        raise ValueError("dedup_segment_sum: rows on %s, values on %s"
                         % (rows.device, values.device))
    if rows.dim() != 1 or rows.dtype not in (torch.int32, torch.int64):
        raise ValueError("dedup_segment_sum: rows must be a 1-D int32 or "
                         "int64 tensor; got %s %s"
                         % (tuple(rows.shape), rows.dtype))
    if values.dim() < 1 or values.shape[0] != rows.shape[0]:
        raise ValueError("dedup_segment_sum: values must be [N, ...] with "
                         "N = %d rows; got %s"
                         % (rows.shape[0], tuple(values.shape)))
    if not values.is_contiguous():
        raise ValueError("dedup_segment_sum: values must be contiguous")


def dedup_segment_sum(rows, values, height):
    """Sum the values of duplicate rows without dynamic shapes.

    Returns ``(out_rows [N], out_values [N, ...])``: each unique input row
    appears exactly once, at its first sorted position, with its values
    summed in f32 and cast to ``values.dtype``; every other slot has
    ``out_rows == height`` and zero values.  ``out_rows`` has ``rows``'
    dtype."""
    _check(rows, values)
    if rows.device.type == "cpu":
        return segsum_plain(rows, values, height)
    if rows.device.type != "cuda":
        raise ValueError("dedup_segment_sum: unsupported device %s"
                         % rows.device)
    keys, order = torch.sort(rows, stable=True)
    return _segsum_sorted(keys, order, values, height)


def _workspace(device, stream, tiles, d):
    """The kernel's scratch (partial [tiles, d] and own [tiles, d] f32, then
    spill and run_end [chunks, tiles] int32, a chunk being 32 columns of d;
    every call rewrites what it reads) and its run counters [chunks, tiles]
    (zeroed when allocated; every launch leaves them at 0).  Both grow as
    needed and are reused by the calls on one stream of one device, which
    run one after another; a call on another stream gets its own."""
    blocks = tiles * -(-d // _COLS)
    need = 2 * tiles * d + 2 * blocks
    key = (device.index, stream)
    work = _WORK.get(key)
    if work is None or work[0].numel() < need or work[1].numel() < blocks:
        work = _WORK[key] = (
            torch.empty(need, device=device, dtype=torch.float32),
            torch.zeros(blocks, device=device, dtype=torch.int32))
    return work


def _segsum_sorted(keys, order, values, height):
    """The kernel alone, on inputs ``dedup_segment_sum`` has checked:
    ``keys`` the ids sorted by a stable ``torch.sort``, ``order`` (int64)
    its permutation, ``values`` contiguous in the original order, all on
    one CUDA device.  One CUDA launch, on the current stream."""
    code = _common.dtype_code(values.dtype, "dedup_segment_sum")
    n = keys.shape[0]
    d = values.numel() // n if n else 0
    out = torch.empty_like(values)
    out_rows = torch.empty_like(keys)
    if n == 0 or d == 0:
        out.zero_()
        out_rows.copy_(keys)
        return out_rows, out
    tiles = -(-n // _TILE)
    stream = _common.stream_ptr(keys.device)
    scratch, runs = _workspace(keys.device, stream, tiles, d)
    _common.check_status("segment_sum", _common.load_library().ptt_segment_sum(
        keys.data_ptr(), order.data_ptr(), values.data_ptr(), out.data_ptr(),
        out_rows.data_ptr(), scratch.data_ptr(), runs.data_ptr(), n, d,
        int(height), int(keys.dtype == torch.int64), code, stream))
    _common.count_launch("segment_sum")
    return out_rows, out


def scatter_rows_drop(table, rows, values):
    """``table[rows] += values`` in place with JAX's ``mode="drop"``: an id
    in ``[-height, 0)`` counts from the end, as JAX indexing normalises it,
    and any other id outside ``[0, height)`` is dropped.  No host sync: a
    dropped slot adds zeros to row ``slot % height`` instead of being masked
    out by a boolean index (``nonzero`` would synchronise); spreading them
    keeps the merged layouts' many sentinel slots from contending on one
    row's atomics.  Returns ``table``."""
    height = table.shape[0]
    rows = torch.where(rows < 0, rows + height, rows)
    valid = (rows >= 0) & (rows < height)
    spread = torch.arange(rows.shape[0], device=rows.device,
                          dtype=rows.dtype) % max(height, 1)
    idx = torch.where(valid, rows, spread)
    vals = torch.where(valid.view(-1, *([1] * (values.dim() - 1))), values,
                       torch.zeros((), dtype=values.dtype,
                                   device=values.device))
    return table.index_add_(0, idx, vals.to(table.dtype))


def apply_rows_update(table, rows, values, scale=1.0):
    """Dedup ``(rows, values)`` through the kernel and apply
    ``table += scale * merged`` as one drop-mode add per unique row.  Updates
    ``table`` in place (the reference returns a new array; here nothing else
    holds the old one) and returns it."""
    mrows, mvals = dedup_segment_sum(rows, values, table.shape[0])
    return scatter_rows_drop(table, mrows, (scale * mvals).to(table.dtype))
