"""Streaming online learning: train->serve without stopping either side
(counterpart of ``paddle_tpu/online``).

Parity surface: the reference's online-learning deployment loop —
async_executor / PSLib streaming training with periodic save_base /
save_delta publishes that a serving replica hot-loads.  Three pieces:

- ``StreamingSource`` (stream.py): an append-only, cursor-resumable
  dataset front that feeds ``train_from_dataset`` forever and resumes
  bit-exact from a committed watermark;
- ``DeltaPublisher`` (publish.py): per-interval delta checkpoints — dense
  weights plus only the HostPS rows touched since the last publish —
  riding the shard/CRC/COMMIT protocol as an atomic, versioned
  ``publish-<n>`` chain, with a TrainSentinel quarantine gate that vetoes
  a diverged interval;
- ``VersionSwapper`` (swap.py): applies a chain to a LIVE ServeEngine
  replica with zero dropped requests and zero captures (the graphs read
  the weights from buffers the flip overwrites), flipping at a step
  boundary and rolling back through the same path.
"""

from .publish import (DeltaPublisher, committed_publishes, latest_version,
                      load_chain_dense, load_chain_rows, load_publish_rows,
                      resolve_chain)
from .stream import StreamingSource
from .swap import VersionSwapper

__all__ = ["StreamingSource", "DeltaPublisher", "VersionSwapper",
           "committed_publishes", "latest_version", "resolve_chain",
           "load_chain_rows", "load_publish_rows", "load_chain_dense"]
