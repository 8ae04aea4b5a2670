"""Distributed Python API (counterpart of ``paddle_tpu/distributed``;
parity: SURVEY.md §2.8 — DistributeTranspiler, Fleet facade + role makers,
`python -m paddle_tpu_torch.distributed.launch` launcher).

The engine underneath is ``torch.distributed`` with one process per rank and
the mesh collectives of ``parallel/``: ``fleet.init()`` joins the world the
launcher's PADDLE_* env describes.  The GeoSGD ``communicator`` and the
heartbeat wait (ROADMAP Queue 1 item 5-B).
"""

from . import fleet  # noqa: F401
from .role_maker import (  # noqa: F401
    PaddleCloudRoleMaker,
    UserDefinedRoleMaker,
    Role,
)
from .transpiler import DistributeTranspiler, DistributeTranspilerConfig  # noqa: F401

__all__ = ["fleet", "PaddleCloudRoleMaker", "UserDefinedRoleMaker", "Role",
           "DistributeTranspiler", "DistributeTranspilerConfig"]
