"""Jittered-exponential-backoff retry for IO that is routine to fail (a
copy of the JAX package's ``ft/retry.py``, which imports no JAX, counting
into the port's ``monitor`` registry).

Parity surface: the reference's pserver client retry loops — GRPC send/recv
with FLAGS_rpc_retry_times and the communicator's resend-on-timeout
(grpc_client.cc retry bookkeeping, checkpoint_notify resend) — translated to
the TPU host's failure domain: shared-filesystem checkpoint IO, dataset file
opens off network mounts, HostPS sparse-shard save/restore, and the ShardPS
request-reply wire (hostps/wire.py).  Transient failures there are ROUTINE
(NFS hiccup, preempted fileserver, quota race, a slow shard's reply missing
one deadline); a training job must absorb them, count them, and only give up
after a bounded, jittered backoff.

Counters (monitor registry, visible in metrics.prom and the monitor table),
LABELED BY SURFACE so a drill gate can assert "giveups == 0 on the wire"
without being fooled by checkpoint retries:

``ft.retry.attempts{surface=}`` — failed tries that were retried;
``ft.retry.giveups{surface=}``  — operations that exhausted the budget and
                                  raised;
``ft.retry.aborts{surface=}``   — operations abandoned EARLY because
                                  ``give_up_when`` explained the failure (a
                                  dead peer is a detected fault the caller
                                  degrades around, not an IO giveup).

The surface taxonomy: ``ckpt_io`` (checkpoint shards/index/commit),
``dataset_open`` (reader file opens), ``hostps_shard`` (sparse-shard
save/restore), ``ps_wire`` (the ShardPS request-reply transport), ``other``
(unlabeled legacy callers).  The chaos drills' gates assert
``ft.retry.giveups == 0`` across every surface — a healthy run retries, it
never gives up.

Chaos: every attempt passes the ``io_error`` injection point (ft/chaos.py),
so ``arm("io_error", times=2)`` makes the next retry-wrapped operation fail
twice and succeed on the third try — the backoff path is drillable without
a real flaky filesystem.
"""

import os
import random
import time

from ..monitor.registry import stat_add
from . import chaos as _chaos

__all__ = ["io_retry", "retrying", "open_retry", "default_attempts",
           "count_attempt", "count_giveup", "count_abort", "SURFACES"]

# the known retry surfaces (labels on ft.retry.*); free-form strings are
# accepted, these are the ones the gates and docs name
SURFACES = ("ckpt_io", "dataset_open", "hostps_shard", "ps_wire", "other")


def default_attempts():
    """Retry budget per operation — PADDLE_TPU_IO_RETRIES (default 4 tries
    total: one initial + three retries)."""
    try:
        return max(int(os.environ.get("PADDLE_TPU_IO_RETRIES", "4")), 1)
    except ValueError:
        return 4


def count_attempt(surface, what=None):
    """Count one absorbed-and-retried failure on `surface` (the shared
    bookkeeping for io_retry AND bespoke retry loops like the ShardPS
    wire's liveness-aware resend, hostps/wire.py)."""
    stat_add("ft.retry.attempts", surface=surface or "other")
    if what:
        stat_add("ft.retry.attempts_by", what=what)


def count_giveup(surface):
    """Count one exhausted-budget giveup on `surface`."""
    stat_add("ft.retry.giveups", surface=surface or "other")


def count_abort(surface):
    """Count one early abandon on `surface` (``give_up_when`` explained the
    failure; the caller degrades instead of burning the backoff budget)."""
    stat_add("ft.retry.aborts", surface=surface or "other")


def io_retry(fn, *args, attempts=None, base=0.02, cap=1.0,
             retry_on=(OSError,), what=None, surface=None,
             give_up_when=None, **kwargs):
    """Call ``fn(*args, **kwargs)``; on ``retry_on`` (default OSError —
    IOError is its alias) retry with jittered exponential backoff:
    sleep ``min(cap, base * 2**k) * uniform(0.5, 1.5)`` after failure k.
    Exhausting the budget re-raises the LAST error and counts a giveup
    under ``surface`` (default "other"; ``what`` stays the finer per-op
    label on ``ft.retry.attempts_by``).

    ``give_up_when`` (optional callable): consulted after every failure —
    when truthy, the failure is EXPLAINED (e.g. the peer this IO targets is
    provably dead per the heartbeat monitor) and retrying cannot help: the
    error re-raises immediately and counts ``ft.retry.aborts``, NOT a
    giveup.  The ShardPS router uses this so a dead shard degrades to
    cache-serving instead of reading as a wire giveup.

    Note ChaosError (an injected crash) is a RuntimeError, not an OSError:
    injected crashes always surface; only injected TRANSIENTS
    (ChaosIOError) are absorbed here."""
    n = attempts if attempts is not None else default_attempts()
    for k in range(n):
        try:
            _chaos.maybe_fire("io_error")
            return fn(*args, **kwargs)
        except retry_on:
            if give_up_when is not None and give_up_when():
                count_abort(surface)
                raise
            if k == n - 1:
                count_giveup(surface)
                raise
            count_attempt(surface, what=what)
            time.sleep(min(cap, base * (2.0 ** k)) * (0.5 + random.random()))


def retrying(**cfg):
    """Decorator form of io_retry: ``@retrying(what="hostps save",
    surface="hostps_shard")``."""

    def wrap(fn):
        def inner(*args, **kwargs):
            return io_retry(fn, *args, **cfg, **kwargs)

        inner.__name__ = getattr(fn, "__name__", "retrying")
        inner.__doc__ = fn.__doc__
        return inner

    return wrap


def open_retry(path, mode="r", **kwargs):
    """``open()`` with the backoff policy — the dataset reader's file-open
    wrapper (a file list on a network mount opens flakily under load)."""
    return io_retry(open, path, mode, what="open", surface="dataset_open",
                    **kwargs)
