"""DataLoader (parity: python/paddle/fluid/reader.py:73 —
DataLoader.from_generator feeding a blocking queue drained by
operators/reader/buffered_reader.h double-buffer prefetch; counterpart of
the JAX package's ``reader.py``).

The C++ LoDTensorBlockingQueue + buffered_reader prefetch pipeline maps to
``feed_pipe.DeviceFeedPipe``: a background thread stages each batch in
pinned host memory and starts its copy to the card on a side stream ahead
of consumption.  The target is a ``torch.device`` taken from ``places``
(the card when none is given).  The file-based dataset path uses the
native C++ parser/channel in runtime/datafeed.cc — see dataset.py; this
module covers the generator-feeding path."""

import warnings

import numpy as np

from .feed_pipe import DeviceFeedPipe
from .monitor import trace as _trace

__all__ = ["DataLoader", "PyReader"]

_CAPACITY_WARNED = []


class _GeneratorLoader:
    def __init__(self, feed_list, capacity, iterable=True, return_list=False,
                 use_double_buffer=True):
        self._feed_list = feed_list or []
        self._capacity = capacity
        self._iterable = iterable
        self._return_list = return_list
        self._use_double_buffer = use_double_buffer
        self._batch_reader = None
        self._places = None
        self._feeder = None

    # -- configuration -----------------------------------------------------
    def set_sample_generator(self, reader, batch_size, drop_last=True, places=None):
        def batch_reader():
            batch = []
            for sample in reader():
                batch.append(sample)
                if len(batch) == batch_size:
                    yield batch
                    batch = []
            if batch and not drop_last:
                yield batch

        return self.set_sample_list_generator(batch_reader, places)

    def set_sample_list_generator(self, reader, places=None):
        from .data_feeder import DataFeeder

        feeder = DataFeeder(self._feed_list)

        def to_feed():
            for sample_list in reader():
                # feed assembly runs on the pipe worker when double-buffered
                # — the span lands on that thread's trace track
                with _trace.span("dataloader.feed"):
                    batch = feeder.feed(sample_list)
                yield batch

        self._batch_reader = to_feed
        self._places = places
        return self

    def set_batch_generator(self, reader, places=None):
        """reader yields ready feed dicts or tuples of arrays."""
        names = [v.name for v in self._feed_list]

        def to_feed():
            for batch in reader():
                if isinstance(batch, dict):
                    yield batch
                else:
                    with _trace.span("dataloader.batch"):
                        batch = dict(
                            zip(names, [np.asarray(b) for b in batch]))
                    yield batch

        self._batch_reader = to_feed
        self._places = places
        return self

    # -- iteration ---------------------------------------------------------
    def _device(self):
        """Copy target derived from places (buffered_reader.h:31 keeps one
        TensorArray per place; here one ``torch.device``): the first
        place's device, or the card when no place is given."""
        from .kernels._common import resolve_device

        places = self._places
        if places:
            p = places[0] if isinstance(places, (list, tuple)) else places
            return resolve_device(p.device() if hasattr(p, "device") else p)
        return resolve_device(None)

    def _convert_fn(self):
        """Worker-side feed conversion — the shared staging rule
        (feed_pipe.make_feed_convert) over this loader's declared feed
        vars: each value is coerced to its declared dtype, then staged on
        the device, so ``Executor.run`` takes the staged tensors as they
        are."""
        from .dtypes import numpy_dtype
        from .feed_pipe import make_feed_convert, make_placer

        dtypes = {}
        for v in self._feed_list:
            try:
                dtypes[v.name] = numpy_dtype(v.dtype)
            except (ValueError, KeyError):
                continue            # bfloat16 or odd dtype: pass through
        return make_feed_convert(
            dtypes.get, make_placer(self._device(), max(self._capacity, 2) + 2))

    def __iter__(self):
        if self._batch_reader is None:
            raise RuntimeError("DataLoader: no generator set")
        # NOTE: deliberately NOT gated on PADDLE_TPU_FEED_PIPE — that env
        # restores each call-site's PRE-pipe behavior, and this loader was
        # double-buffered long before the shared pipe existed; its opt-out
        # is the use_double_buffer flag itself
        if not self._use_double_buffer:
            yield from self._batch_reader()
            return
        if self._capacity < 2:
            # a 1-deep buffer cannot overlap (the producer always hands off
            # synchronously) — say so once, then CLAMP to 2 rather than
            # silently degrading to inline (the pre-pipe worker clamped the
            # same way, so existing capacity=1 callers keep their overlap)
            if not _CAPACITY_WARNED:
                _CAPACITY_WARNED.append(True)
                warnings.warn(
                    "DataLoader.from_generator(use_double_buffer=True, "
                    "capacity=%d): capacity < 2 cannot overlap the next "
                    "batch's transfer with compute; clamping the device "
                    "feed pipe depth to 2" % self._capacity,
                    stacklevel=2)
        # Double-buffered device prefetch (reader/buffered_reader.h:31),
        # routed through the shared DeviceFeedPipe stage: a background
        # thread converts each batch to the declared dtypes AND starts the
        # host->device copy (pinned buffer, side stream), so the copy of
        # batch k+1 overlaps the compute of batch k.  Order is
        # preserved; worker exceptions re-raise here with their original
        # traceback; abandoning the iterator shuts the worker down.
        pipe = DeviceFeedPipe(self._batch_reader(), convert=self._convert_fn(),
                              depth=max(self._capacity, 2),
                              name="dataloader_pipe")
        try:
            yield from pipe
        finally:
            pipe.close()

    # start/reset parity for the non-iterable py_reader style
    def start(self):
        self._iter = iter(self)

    def reset(self):
        self._iter = None

    def next(self):
        return next(self._iter)


class DataLoader:
    @staticmethod
    def from_generator(feed_list=None, capacity=16, use_double_buffer=True,
                       iterable=True, return_list=False, use_multiprocess=False):
        """Parity: reader.py:75 DataLoader.from_generator."""
        return _GeneratorLoader(feed_list, capacity, iterable, return_list,
                                use_double_buffer)

    @staticmethod
    def from_dataset(dataset, places, drop_last=True):
        def gen():
            yield from dataset

        loader = _GeneratorLoader(None, capacity=8)
        loader._batch_reader = gen
        loader._places = places
        return loader


# legacy alias (reference fluid.io.PyReader)
PyReader = _GeneratorLoader
