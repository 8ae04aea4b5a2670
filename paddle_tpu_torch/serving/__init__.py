"""Online serving (ServeLoop), the counterpart of ``paddle_tpu/serving``:
continuous batching on a pre-captured bucket lattice.

``ServeEngine`` feeds an ``ExportedPredictor`` from a bounded request
queue with per-step admit/evict continuous batching, every dispatchable
shape captured at server start (one CUDA graph per lattice point on the
card; steady state never captures — the strict RecompileDetector enforces
it), MemScope-gated admission (``Backpressure`` instead of OOM), and
read-only HostPS CTR lookups.  ``tools/serve_bench.py --check`` is the
receipts.  ``CanaryProber`` runs known-answer probes over anything with
``submit`` + ``snapshot``.

FleetServe scales it horizontally: ``FleetRouter`` (router.py) dispatches
over the hostps wire to N replica processes (fleet.py), each capturing
its own lattice and pulling sparse rows from read-only ShardPS owners
through ``FleetCTRView``.  ``tools/serve_bench.py --fleet`` measures 1 and
3 replicas; ``tools/chaos_drill.py --fleet`` kills a replica mid-trace.

LoadShield (shield.py) is the tier's overload reflexes, riding the
router's hot path: deadline propagation end to end, priority-aware
shedding past a load watermark, token-bucket retry budgets + hedging,
per-replica latency/error circuit breakers with half-open single-probe
readmission, lame-duck draining, and ShardPS brownout
(``degraded_reads="init"``).
"""

from . import engine
from .canary import CanaryProber
from .engine import (Backpressure, BucketLattice, CTRLookup, QueueFull,
                     RequestTooLarge, ServeEngine, ServeError, ServeRequest)
from .fleet import FleetCTRView, FleetManager, autoscale_signal
from .metrics import LatencyTracker, ServeStats
from .queue import (PRIORITY_HIGH, PRIORITY_LOW, PRIORITY_NORMAL,
                    DeadlineExceeded, Draining, RequestQueue, Shed)
from .router import FleetGiveUp, FleetRouter, ReplicaInfo
from .shield import ReplicaBreaker, RetryBudget, ShedPolicy, ShieldConfig

__all__ = [
    "ServeEngine", "BucketLattice", "CTRLookup", "ServeRequest",
    "RequestQueue", "ServeStats", "LatencyTracker",
    "ServeError", "QueueFull", "Backpressure", "RequestTooLarge",
    "DeadlineExceeded", "Shed", "Draining",
    "PRIORITY_LOW", "PRIORITY_NORMAL", "PRIORITY_HIGH",
    "FleetRouter", "FleetGiveUp", "ReplicaInfo",
    "FleetCTRView", "FleetManager", "autoscale_signal",
    "RetryBudget", "ReplicaBreaker", "ShedPolicy", "ShieldConfig",
    "CanaryProber",
]
