"""contrib namespace (parity: python/paddle/fluid/contrib/): so far
``mixed_precision`` and ``layers``; slim waits (ROADMAP Queue 1 item
3-D)."""

from . import mixed_precision  # noqa: F401
from . import layers  # noqa: F401
