"""IO layers (parity: layers/io.py): the `data` feed declaration and the
py_reader family (counterpart of the JAX package's ``layers/io.py``); the
double-buffered pipeline behind py_reader is ``reader.py``'s DataLoader on
``feed_pipe.DeviceFeedPipe``."""

from ..framework import default_main_program

__all__ = ["data", "py_reader", "create_py_reader_by_data", "read_file",
           "EOFException"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True):
    """Parity: layers/io.py data — declares a feed variable.  The leading
    batch dim is dynamic (-1) when append_batch_size is True."""
    full_shape = list(shape)
    if append_batch_size:
        full_shape = [-1] + full_shape
    block = default_main_program().global_block()
    if name in block.vars:
        return block.vars[name]
    return block.create_var(
        name=name,
        shape=tuple(full_shape),
        dtype=dtype,
        lod_level=lod_level,
        is_data=True,
        stop_gradient=stop_gradient,
    )


class EOFException(Exception):
    """Raised when a started py_reader runs out of data
    (parity: fluid.core.EOFException from read_file at end-of-epoch)."""


class _ProgramPyReader:
    """Program-mode py_reader (parity: layers/io.py py_reader over
    reader/create_py_reader_op.cc + buffered_reader.h).

    Usage matches the reference: build the program on the vars returned by
    read_file(reader), decorate with a data source, start(); each
    Executor.run pulls the next prefetched batch (injected as feed by the
    executor); exhaustion raises EOFException; reset() rearms for the next
    epoch."""

    def __init__(self, capacity, use_double_buffer, feed_vars):
        from ..framework import default_main_program

        self._capacity = capacity
        self._use_double_buffer = use_double_buffer
        self._vars = list(feed_vars)
        self._source = None
        self._places = None
        self._it = None
        program = default_main_program()
        if not hasattr(program, "_py_readers"):
            program._py_readers = []
        program._py_readers.append(self)

    # -- decoration (reference decorate_* family) -----------------------
    def decorate_sample_list_generator(self, reader, places=None):
        from ..data_feeder import DataFeeder

        feeder = DataFeeder(self._vars)

        def gen():
            for sample_list in reader():
                yield feeder.feed(sample_list)

        self._source = gen
        self._places = places
        return self

    decorate_paddle_reader = decorate_sample_list_generator

    def decorate_batch_generator(self, reader, places=None):
        names = [v.name for v in self._vars]

        def gen():
            for batch in reader():
                if isinstance(batch, dict):
                    yield batch
                else:
                    import numpy as _np

                    yield dict(zip(names, [_np.asarray(b) for b in batch]))

        self._source = gen
        self._places = places
        return self

    def decorate_tensor_provider(self, reader, places=None):
        return self.decorate_batch_generator(reader, places)

    # -- lifecycle ------------------------------------------------------
    def start(self):
        if self._source is None:
            raise RuntimeError("py_reader: decorate a data source first")
        from ..reader import DataLoader

        loader = DataLoader.from_generator(
            feed_list=self._vars, capacity=self._capacity,
            use_double_buffer=self._use_double_buffer)
        # the staged batches go to ``places`` (the card when none was given)
        loader.set_batch_generator(self._source, places=self._places)
        self._it = iter(loader)

    def reset(self):
        it, self._it = self._it, None
        if it is not None:
            it.close()

    # -- executor hook --------------------------------------------------
    def _inject_feed(self, feed):
        if self._it is None:
            return feed
        names = [v.name for v in self._vars]
        if all(n in feed for n in names):
            return feed
        try:
            batch = next(self._it)
        except StopIteration:
            self._it = None
            raise EOFException("py_reader: data source exhausted")
        merged = dict(feed)
        merged.update(batch)
        return merged


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """Parity: layers/io.py py_reader.  A -1/None leading dim declares a
    dynamic batch; a concrete leading dim is kept as-is."""
    from .. import unique_name

    base = name or unique_name.generate("py_reader")
    feed_vars = []
    for i, (shape, dtype) in enumerate(zip(shapes, dtypes)):
        name_i = "%s_slot%d" % (base, i)
        if shape[0] in (-1, None):
            v = data(name_i, shape=list(shape)[1:], dtype=dtype,
                     append_batch_size=True)
        else:
            v = data(name_i, shape=list(shape), dtype=dtype,
                     append_batch_size=False)
        feed_vars.append(v)
    return _ProgramPyReader(capacity, use_double_buffer, feed_vars)


def create_py_reader_by_data(capacity, feed_list, name=None,
                             use_double_buffer=True):
    """Parity: layers/io.py create_py_reader_by_data — reader over existing
    data vars."""
    return _ProgramPyReader(capacity, use_double_buffer, feed_list)


def read_file(reader):
    """Parity: layers/io.py read_file — yields the reader's data vars."""
    vs = reader._vars
    return vs[0] if len(vs) == 1 else list(vs)
