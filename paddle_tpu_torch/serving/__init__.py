"""Serving (counterpart of ``paddle_tpu/serving``).  So far only the
bucket lattice, which ``inference.ExportedPredictor.declare_batch_buckets``
uses; the queue, the engine, the router and the fleet wait (ROADMAP Queue 1
item 10)."""

from .lattice import BucketLattice, RequestTooLarge

__all__ = ["BucketLattice", "RequestTooLarge"]
