"""DataFeeder (parity: python/paddle/fluid/data_feeder.py) — converts
minibatch row tuples into the dense feed dict the Executor consumes.  A
copy of the JAX package's ``data_feeder.py``.

Ragged feeds (parity: DataToLoDTensorConverter, data_feeder.py:67-87): the
reference accepts nested Python lists for lod_level>0 vars and builds the
LoD on the fly.  The survey's LoD translation is dense-with-lengths
(SURVEY §7 / layers/sequence.py), so here a ragged column is zero-padded to
the batch max and the per-row lengths are emitted as an extra
'<name>_seq_len' int64 feed — exactly what the sequence ops' `seq_len`
input consumes.  Two-level nesting (lists of lists per row) pads both axes
and emits '<name>_seq_len' ([B] outer lengths) plus '<name>_seq_len2'
([B, max_outer] inner lengths)."""

import numpy as np

from .framework import default_main_program
from .dtypes import numpy_dtype

__all__ = ["DataFeeder"]


def _is_seq(row):
    return isinstance(row, (list, tuple)) or (
        isinstance(row, np.ndarray) and row.ndim >= 1)


def _row_len(row):
    return len(row)


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None):
        self.program = program or default_main_program()
        self.feed_vars = []
        for v in feed_list:
            if isinstance(v, str):
                v = self.program.global_block().var(v)
            self.feed_vars.append(v)
        self.place = place

    # -- ragged handling ----------------------------------------------------
    def _ragged_level(self, var, col):
        """0 = dense; 1 = rows are variable-length sequences; 2 = rows are
        variable lists of variable-length sequences.  Follows the reference:
        raggedness is driven by the var's DECLARED lod_level
        (DataToLoDTensorConverter keys on lod_level, data_feeder.py:67);
        ragged rows fed to a lod_level=0 var are a data error, not a reason
        to silently pad."""
        if not all(_is_seq(c) for c in col):
            return 0
        declared = getattr(var, "lod_level", 0) or 0
        if declared == 0:
            lens = {_row_len(c) for c in col}
            if len(lens) > 1:
                raise ValueError(
                    "feed var '%s' is declared dense (lod_level=0) but rows "
                    "have differing lengths %s — declare lod_level=1 (or fix "
                    "the data)" % (var.name, sorted(lens)))
            return 0
        return min(declared, 2)

    def _pad_level1(self, var, col, dtype):
        lens = np.asarray([_row_len(c) for c in col], np.int64)
        width = int(lens.max()) if len(lens) else 0
        rows = []
        for c in col:
            try:
                arr = np.asarray(c, dtype=dtype)
            except ValueError as e:
                raise ValueError(
                    "feed var '%s' is declared lod_level=1 but a row is "
                    "itself ragged (%s) — declare lod_level=2 for "
                    "two-level nesting" % (var.name, e)) from e
            pad = [(0, width - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
            rows.append(np.pad(arr, pad))
        return np.stack(rows), lens

    def _pad_level2(self, var, col, dtype):
        outer = np.asarray([_row_len(c) for c in col], np.int64)
        max_outer = int(outer.max()) if len(outer) else 0
        inner = np.zeros((len(col), max_outer), np.int64)
        max_inner = 1
        for i, c in enumerate(col):
            for j, e in enumerate(c):
                inner[i, j] = _row_len(e)
                max_inner = max(max_inner, _row_len(e))
        batch = np.zeros((len(col), max_outer, max_inner), dtype=dtype)
        for i, c in enumerate(col):
            for j, e in enumerate(c):
                arr = np.asarray(e, dtype=dtype)
                batch[i, j, :arr.shape[0]] = arr
        return batch, outer, inner

    def feed(self, iterable):
        """iterable: list of row tuples, one entry per feed var.  Rows may be
        raw nested Python lists for sequence vars — they are padded and the
        lengths tensors emitted automatically."""
        columns = list(zip(*iterable))
        block = self.program.global_block()
        result = {}
        for var, col in zip(self.feed_vars, columns):
            dtype = numpy_dtype(var.dtype)
            level = self._ragged_level(var, col)
            if level == 2:
                batch, outer, inner = self._pad_level2(var, col, dtype)
                result[var.name] = batch
                result[var.name + "_seq_len"] = outer
                result[var.name + "_seq_len2"] = inner
                continue
            if level == 1:
                batch, lens = self._pad_level1(var, col, dtype)
                result[var.name] = batch
                # the Executor tolerates feed names the program doesn't
                # declare, so the lengths always ride along (same policy as
                # level 2) — models consume them via a '<name>_seq_len' var
                result[var.name + "_seq_len"] = lens
                continue
            arrs = [np.asarray(c) for c in col]
            batch = np.stack(arrs).astype(dtype)
            # reshape rows to declared trailing shape when flat (e.g. mnist 784 -> 1,28,28)
            want = [s for s in var.shape[1:]]
            if all(s > 0 for s in want) and batch.ndim >= 1:
                need = int(np.prod(want))
                got = int(np.prod(batch.shape[1:])) if batch.ndim > 1 else 1
                if got == need and list(batch.shape[1:]) != want:
                    batch = batch.reshape([batch.shape[0]] + want)
                elif batch.ndim == 1 and need == 1:
                    batch = batch.reshape(-1, *want)
            result[var.name] = batch
        return result
