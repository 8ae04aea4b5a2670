"""Distributed Python API (counterpart of ``paddle_tpu/distributed``;
parity: SURVEY.md §2.8 — DistributeTranspiler, Fleet facade + role makers,
`python -m paddle_tpu_torch.distributed.launch` launcher).

The engine underneath is ``torch.distributed`` with one process per rank and
the mesh collectives of ``parallel/``: ``fleet.init()`` joins the world the
launcher's PADDLE_* env describes, and the executor runs fleet- and
transpiler-tagged programs data-parallel over it.  ``Communicator`` is
GeoSGD's periodic parameter averaging; ``heartbeat`` the failure
detection.
"""

from . import fleet  # noqa: F401
from .role_maker import (  # noqa: F401
    PaddleCloudRoleMaker,
    UserDefinedRoleMaker,
    Role,
)
from .transpiler import DistributeTranspiler, DistributeTranspilerConfig  # noqa: F401
from .communicator import Communicator  # noqa: F401
from . import heartbeat  # noqa: F401

__all__ = ["fleet", "PaddleCloudRoleMaker", "UserDefinedRoleMaker", "Role",
           "DistributeTranspiler", "DistributeTranspilerConfig",
           "Communicator"]
