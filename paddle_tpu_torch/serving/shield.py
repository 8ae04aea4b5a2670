"""LoadShield: overload-control bookkeeping for the serving fleet
(counterpart of ``paddle_tpu/serving/shield.py``, a copy: stdlib only).
Only the fleet router calls it, and the port's router waits (ROADMAP
Queue 1 item 10-B); until then its unit tests hold it.

Parity: the reference's serving tier survives demand spikes through the
retrying RPC client's backoff/giveup discipline (``grpc_client.cc``
FLAGS_rpc_retry_times around ``listen_and_serv``) and the
AnalysisPredictor pool's bounded-queue refusal — the two organs that turn
"over capacity" into fast typed pushback instead of congestion collapse.
This module is those reflexes made explicit, as PURE BOOKKEEPING the
FleetRouter consults on its dispatch hot path:

- ``RetryBudget``: a token-bucket retry budget (the gRPC retry-throttling
  shape).  Every primary request EARNS ``ratio`` tokens (~10% by
  default); every re-route, hedge, or sibling retry SPENDS one.  Under a
  replica kill at full load, re-dispatch amplification is capped at
  ~(1 + ratio)× — a retry storm is arithmetically impossible, and a
  denied retry becomes a counted giveup instead of more offered load.
- ``ReplicaBreaker``: a per-replica circuit breaker over a latency EWMA
  and an error-rate EWMA.  It trips on *degraded* replicas — slow but
  alive, the failure mode the wire deadline never catches early — and
  readmits half-open: after ``cooloff_s`` exactly ONE probe request is
  allowed through (canary-style); its verdict closes the breaker or
  re-opens it.
- ``ShedPolicy``: priority-aware load shedding.  Past a per-replica load
  watermark the fleet sheds its lowest priority class first, as a typed
  ``Shed(retry_after_ms)`` fast-fail; higher classes ride progressively
  higher watermarks, so paid traffic survives a storm the batch tier
  caused.

Everything here is branch-and-float-math cheap enough to live inside the
router's 0.5%-of-request dispatch budget (the combined ``_pick`` +
``_note_reply`` + breaker-EWMA + budget-tick cost).  No I/O, no imports
beyond the stdlib, no locks on the per-request earn path (the router's own lock already serializes the
breaker and shed reads; the budget's earn is a benign GIL-atomic float
update — a lost increment under-counts the budget, which only errs
conservative).

The DEFAULTS ARE INERT: no watermark, no breaker thresholds, no hedging.
A shield-enabled router on a healthy fleet sheds nothing, trips nothing,
and spends no budget.
"""

import threading

__all__ = ["RetryBudget", "ReplicaBreaker", "ShedPolicy", "ShieldConfig"]


class RetryBudget:
    """Token-bucket retry budget: primaries earn ``ratio`` tokens, every
    re-dispatch spends one, the bucket caps at ``cap`` so an idle hour
    cannot bank an unbounded storm.  ``seed`` pre-fills the bucket so a
    cold router can still absorb an early fault."""

    __slots__ = ("ratio", "cap", "tokens", "spent", "denied", "_lock")

    def __init__(self, ratio=0.1, cap=32.0, seed=8.0):
        self.ratio = float(ratio)
        self.cap = float(cap)
        self.tokens = min(float(seed), self.cap)
        self.spent = 0
        self.denied = 0
        self._lock = threading.Lock()

    def observe(self):
        """One primary request seen — earn.  Lock-free on purpose: this is
        the per-request hot path, and a raced (lost) earn only makes the
        budget stricter."""
        t = self.tokens + self.ratio
        self.tokens = t if t < self.cap else self.cap

    def try_spend(self, cost=1.0):
        """Spend for one re-dispatch; False = budget exhausted (the caller
        gives up typed instead of amplifying).  Locked: spends are rare
        (faults only) and must not double-spend a last token."""
        with self._lock:
            if self.tokens >= cost:
                self.tokens -= cost
                self.spent += 1
                return True
            self.denied += 1
            return False

    def refund(self, cost=1.0):
        """Return a token whose re-dispatch never happened (a hedge that
        found no idle sibling, a pick undone by membership churn)."""
        with self._lock:
            self.tokens = min(self.tokens + cost, self.cap)
            self.spent = max(self.spent - 1, 0)

    def snapshot(self):
        return {"tokens": round(self.tokens, 2), "spent": self.spent,
                "denied": self.denied, "ratio": self.ratio}


class ReplicaBreaker:
    """Circuit breaker over one replica's observed service quality.

    States: ``closed`` (normal traffic) -> ``open`` (tripped: the latency
    EWMA crossed ``trip_ms`` or the error-rate EWMA crossed ``trip_err``
    with at least ``min_samples`` observations) -> ``half_open`` (cooloff
    elapsed: exactly one probe admitted) -> ``closed`` on a good probe or
    back to ``open`` on a bad one.

    ``trip_ms=None`` / ``trip_err=None`` disable that trip wire (the
    inert default).  NOT thread-safe by itself — the router mutates it
    under its own lock, which it already holds on both call sites
    (``_pick`` / ``_note_reply``)."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    __slots__ = ("alpha", "trip_ms", "trip_err", "cooloff_s", "min_samples",
                 "lat_ms", "err", "n", "state", "opened_at", "trips")

    def __init__(self, trip_ms=None, trip_err=None, cooloff_s=2.0,
                 alpha=0.2, min_samples=8):
        self.alpha = float(alpha)
        self.trip_ms = None if trip_ms is None else float(trip_ms)
        self.trip_err = None if trip_err is None else float(trip_err)
        self.cooloff_s = float(cooloff_s)
        self.min_samples = int(min_samples)
        self.lat_ms = 0.0
        self.err = 0.0
        self.n = 0
        self.state = self.CLOSED
        self.opened_at = 0.0
        self.trips = 0

    def record(self, ms, error, now):
        """Fold one reply (or one failure) in.  In ``half_open`` this IS
        the probe's verdict."""
        a = self.alpha
        if self.n == 0:
            self.lat_ms = float(ms)
        else:
            self.lat_ms += a * (float(ms) - self.lat_ms)
        self.err += a * ((1.0 if error else 0.0) - self.err)
        self.n += 1
        if self.state == self.HALF_OPEN:
            bad = error or (self.trip_ms is not None
                            and float(ms) > self.trip_ms)
            if bad:
                self.state = self.OPEN
                self.opened_at = now
            else:
                self.state = self.CLOSED
                # the probe proved recovery: forget the degraded window's
                # statistics so the next trip needs fresh evidence
                self.err = 0.0
                self.lat_ms = float(ms)
                self.n = 1
            return
        if self.state != self.CLOSED or self.n < self.min_samples:
            return
        if ((self.trip_ms is not None and self.lat_ms > self.trip_ms)
                or (self.trip_err is not None and self.err > self.trip_err)):
            self.state = self.OPEN
            self.opened_at = now
            self.trips += 1

    def admit(self, now):
        """Dispatch-time verdict: True = normal traffic, False = hold,
        ``"probe"`` = cooloff elapsed and this replica is owed its single
        half-open probe (the caller routes exactly one request and must
        deliver the verdict via ``record``)."""
        if self.state == self.CLOSED:
            return True
        if self.state == self.OPEN:
            if now - self.opened_at >= self.cooloff_s:
                self.state = self.HALF_OPEN
                return "probe"
            return False
        # HALF_OPEN: still owed a verdict.  Keep offering the probe — the
        # router's per-replica probe_inflight flag gates it to ONE at a
        # time, and a probe lost to membership churn must not wedge the
        # breaker half-open forever.
        return "probe"

    def snapshot(self):
        return {"state": self.state, "lat_ewma_ms": round(self.lat_ms, 2),
                "err_ewma": round(self.err, 4), "trips": self.trips,
                "samples": self.n}


# per-priority watermark scaling: the LOW class sheds at 1x the
# watermark, NORMAL at 2x, HIGH at 4x — lowest class first, always
_PRIORITY_SCALE = (1.0, 2.0, 4.0)


class ShedPolicy:
    """Priority-aware depth-watermark shedding.  ``watermark`` is mean
    per-replica load (router outstanding + piggybacked queue depth); past
    ``watermark * scale(priority)`` the request is shed with a typed
    ``retry_after_ms`` hint.  ``watermark=None`` disables (inert)."""

    __slots__ = ("watermark", "retry_after_ms", "sheds")

    def __init__(self, watermark=None, retry_after_ms=50.0):
        self.watermark = None if watermark is None else float(watermark)
        self.retry_after_ms = float(retry_after_ms)
        self.sheds = 0

    def verdict(self, priority, mean_load):
        """None = admit; a float (retry_after_ms) = shed."""
        if self.watermark is None:
            return None
        i = 0 if priority < 0 else (2 if priority > 2 else int(priority))
        if mean_load <= self.watermark * _PRIORITY_SCALE[i]:
            return None
        self.sheds += 1
        return self.retry_after_ms


class ShieldConfig:
    """The router's shield knobs in one bag (every default inert).

    ``breaker_*`` seed each replica's ``ReplicaBreaker``; ``watermark`` /
    ``retry_after_ms`` the ``ShedPolicy``; ``retry_ratio`` / ``retry_cap``
    the ``RetryBudget``; ``hedge_ms`` arms budget-gated request hedging
    (a duplicate dispatch to a second replica once the primary is
    ``hedge_ms`` late — idempotent transport makes it safe, the budget
    keeps it from doubling offered load)."""

    __slots__ = ("breaker_trip_ms", "breaker_trip_err", "breaker_cooloff_s",
                 "breaker_alpha", "breaker_min_samples", "watermark",
                 "retry_after_ms", "retry_ratio", "retry_cap", "hedge_ms")

    def __init__(self, breaker_trip_ms=None, breaker_trip_err=None,
                 breaker_cooloff_s=2.0, breaker_alpha=0.2,
                 breaker_min_samples=8, watermark=None, retry_after_ms=50.0,
                 retry_ratio=0.1, retry_cap=32.0, hedge_ms=None):
        self.breaker_trip_ms = breaker_trip_ms
        self.breaker_trip_err = breaker_trip_err
        self.breaker_cooloff_s = breaker_cooloff_s
        self.breaker_alpha = breaker_alpha
        self.breaker_min_samples = breaker_min_samples
        self.watermark = watermark
        self.retry_after_ms = retry_after_ms
        self.retry_ratio = retry_ratio
        self.retry_cap = retry_cap
        self.hedge_ms = hedge_ms

    def make_breaker(self):
        """``None`` when both trip wires are disabled: an inert breaker
        can never leave CLOSED, so attaching one would only tax the
        reply hot path with EWMA bookkeeping nobody can act on (the
        router's per-dispatch cost is gated at 0.5% of a 1ms request)."""
        if self.breaker_trip_ms is None and self.breaker_trip_err is None:
            return None
        return ReplicaBreaker(
            trip_ms=self.breaker_trip_ms, trip_err=self.breaker_trip_err,
            cooloff_s=self.breaker_cooloff_s, alpha=self.breaker_alpha,
            min_samples=self.breaker_min_samples)

    def make_shed(self):
        return ShedPolicy(watermark=self.watermark,
                          retry_after_ms=self.retry_after_ms)

    def make_budget(self):
        return RetryBudget(ratio=self.retry_ratio, cap=self.retry_cap)
