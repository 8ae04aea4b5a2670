"""The bucketed-shape lattice: the serving path's shape contract.  A copy
of the JAX package's ``serving/lattice.py``.

Parity: the reference's inference engines fix their shapes at analysis time
(AnalysisPredictor optimizes ONE program per input signature; the TensorRT
subgraph engine builds one engine per declared shape profile).  On the card
the port's counterpart of one compiled executable per signature is one
captured CUDA graph per signature (``inference.ExportedPredictor``), so the
serving layer declares its shapes up front — a small grid of batch-size
buckets x (optionally) sequence-length buckets — and every request is
padded UP to the nearest lattice point:

- ``batch_buckets``: ascending row counts, e.g. ``[4, 8, 16, 32]``.  A
  step dispatching n real rows runs the smallest bucket >= n; pad rows are
  zeros and their outputs are sliced away (row-wise models make padding
  bit-exact).
- ``seq_buckets``: optional ascending lengths for ONE designated trailing
  axis (variable-length token inputs).  Padding along the sequence axis is
  only bit-exact for per-position (mask-aware or elementwise) models.

``points()`` enumerates the full grid, the set to capture before serving;
``route()`` maps a request's (rows, seq_len) onto the lattice and raises
``RequestTooLarge`` past the top bucket: admission refuses what the lattice
cannot serve without a new capture.
"""

__all__ = ["BucketLattice", "RequestTooLarge"]


class RequestTooLarge(ValueError):
    """A request's rows (or sequence length) exceed the largest declared
    bucket: serving it would need a shape outside the declared lattice —
    refused at admission, never captured under load."""


def _validate(buckets, what):
    out = [int(b) for b in buckets]
    if not out or any(b <= 0 for b in out) or sorted(set(out)) != out:
        raise ValueError(
            "%s must be strictly ascending positive ints, got %r"
            % (what, list(buckets)))
    return out


class BucketLattice:
    def __init__(self, batch_buckets, seq_buckets=None):
        self.batch_buckets = _validate(batch_buckets, "batch_buckets")
        self.seq_buckets = (_validate(seq_buckets, "seq_buckets")
                            if seq_buckets else None)

    @property
    def max_batch(self):
        return self.batch_buckets[-1]

    @property
    def max_seq(self):
        return self.seq_buckets[-1] if self.seq_buckets else None

    def __len__(self):
        return len(self.batch_buckets) * (len(self.seq_buckets)
                                          if self.seq_buckets else 1)

    @staticmethod
    def _up(n, buckets, what):
        for b in buckets:
            if n <= b:
                return b
        raise RequestTooLarge(
            "%s %d exceeds the largest declared bucket %d — the lattice "
            "cannot serve it without a new capture under load; raise the "
            "lattice or split the request" % (what, n, buckets[-1]))

    def route_batch(self, rows):
        """Smallest batch bucket >= rows (RequestTooLarge past the top)."""
        if rows <= 0:
            raise ValueError("route_batch needs rows > 0, got %d" % rows)
        return self._up(rows, self.batch_buckets, "request rows")

    def route_seq(self, seq_len):
        """Smallest seq bucket >= seq_len; None when the lattice has no
        sequence axis (fixed trailing shapes)."""
        if self.seq_buckets is None:
            return None
        return self._up(seq_len, self.seq_buckets, "sequence length")

    def route(self, rows, seq_len=None):
        """The lattice point serving (rows, seq_len): (batch_bucket,
        seq_bucket-or-None)."""
        b = self.route_batch(rows)
        s = None
        if self.seq_buckets is not None:
            if seq_len is None:
                raise ValueError("lattice declares seq_buckets but the "
                                 "request carries no sequence length")
            s = self.route_seq(seq_len)
        return b, s

    def points(self):
        """Every (batch_bucket, seq_bucket) — the set to capture first."""
        if self.seq_buckets is None:
            return [(b, None) for b in self.batch_buckets]
        return [(b, s) for b in self.batch_buckets
                for s in self.seq_buckets]

    def describe(self):
        return {"batch_buckets": list(self.batch_buckets),
                "seq_buckets": (list(self.seq_buckets)
                                if self.seq_buckets else None)}
