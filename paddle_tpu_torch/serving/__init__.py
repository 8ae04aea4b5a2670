"""Online serving (ServeLoop), the counterpart of ``paddle_tpu/serving``:
continuous batching on a pre-captured bucket lattice.

``ServeEngine`` feeds an ``ExportedPredictor`` from a bounded request
queue with per-step admit/evict continuous batching, every dispatchable
shape captured at server start (one CUDA graph per lattice point on the
card; steady state never captures — the strict RecompileDetector enforces
it), MemScope-gated admission (``Backpressure`` instead of OOM), and
read-only HostPS CTR lookups.  ``tools/serve_bench.py --check`` is the
receipts.  ``CanaryProber`` runs known-answer probes over anything with
``submit`` + ``snapshot``; the LoadShield bookkeeping (shield.py) waits
for its caller, the fleet router.

The fleet tier — ``FleetRouter``, ``FleetGiveUp``, ``ReplicaInfo``,
``FleetCTRView``, ``FleetManager``, ``autoscale_signal`` — is ROADMAP
Queue 1 item 10-B; those names raise ``NotImplementedError`` here.
"""

from . import engine
from .canary import CanaryProber
from .engine import (Backpressure, BucketLattice, CTRLookup, QueueFull,
                     RequestTooLarge, ServeEngine, ServeError, ServeRequest)
from .metrics import LatencyTracker, ServeStats
from .queue import (PRIORITY_HIGH, PRIORITY_LOW, PRIORITY_NORMAL,
                    DeadlineExceeded, Draining, RequestQueue, Shed)
from .shield import ReplicaBreaker, RetryBudget, ShedPolicy, ShieldConfig

__all__ = [
    "ServeEngine", "BucketLattice", "CTRLookup", "ServeRequest",
    "RequestQueue", "ServeStats", "LatencyTracker",
    "ServeError", "QueueFull", "Backpressure", "RequestTooLarge",
    "DeadlineExceeded", "Shed", "Draining",
    "PRIORITY_LOW", "PRIORITY_NORMAL", "PRIORITY_HIGH",
    "RetryBudget", "ReplicaBreaker", "ShedPolicy", "ShieldConfig",
    "CanaryProber",
]

# the multi-process fleet tier of the reference's serving package
FLEET_NAMES = ("FleetRouter", "FleetGiveUp", "ReplicaInfo", "FleetCTRView",
               "FleetManager", "autoscale_signal")


def __getattr__(name):
    if name in FLEET_NAMES:
        raise NotImplementedError(
            "serving.%s belongs to the serving fleet (router, replica "
            "processes, autoscaling), which the port has not brought up "
            "yet: ROADMAP Queue 1 item 10-B" % name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
