"""contrib namespace (parity: python/paddle/fluid/contrib/): so far
``mixed_precision``; slim and the contrib layers wait (ROADMAP Queue 1
item 3)."""

from . import mixed_precision  # noqa: F401
