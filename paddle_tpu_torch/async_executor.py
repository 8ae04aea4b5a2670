"""AsyncExecutor stand-in (a copy of the JAX package's ``async_executor.py``
on the port's ``Executor``; parity: the reference's deprecated
framework/async_executor.h — by v1.6 even the reference's Python class was
removed and its job absorbed by Executor.train_from_dataset; the C++ core
remains only for PSLib.  This module keeps the API name alive and routes it
to the same place the reference routed it: the dataset/trainer path."""

import warnings

from .dataset import DatasetFactory
from .executor import Executor

__all__ = ["AsyncExecutor"]


class AsyncExecutor:
    """API-compat shim: run(program, data_feed, filelist, thread_num,
    fetch) builds a QueueDataset and delegates to
    Executor.train_from_dataset (executor.py:755), exactly the migration
    the reference prescribed when it deprecated AsyncExecutor."""

    def __init__(self, place=None, run_mode=""):
        self.place = place
        self._exe = Executor(place)
        warnings.warn(
            "AsyncExecutor is the reference's deprecated API; use "
            "Executor.train_from_dataset (this shim delegates to it)",
            DeprecationWarning, stacklevel=2)

    def run(self, program, data_feed, filelist, thread_num, fetch,
            mode="", debug=False):
        """data_feed: a Dataset (used as-is) or a list of feed Variables
        (a QueueDataset is built over `filelist` with them)."""
        if hasattr(data_feed, "set_filelist"):
            dataset = data_feed
        else:
            dataset = DatasetFactory().create_dataset("QueueDataset")
            dataset.set_use_var(list(data_feed))
            dataset.set_thread(thread_num)
        dataset.set_filelist(list(filelist))
        return self._exe.train_from_dataset(
            program=program, dataset=dataset, thread=thread_num,
            fetch_list=list(fetch or []), debug=debug)
