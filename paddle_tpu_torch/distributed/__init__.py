"""Distributed Python API (counterpart of ``paddle_tpu/distributed``;
parity: SURVEY.md §2.8).  So far the ``DistributeTranspiler`` and its
config; ``fleet``, the role makers, the launcher and the GeoSGD
``communicator`` wait for the multi-GPU engine (ROADMAP Queue 1 item 5)."""

from .transpiler import DistributeTranspiler, DistributeTranspilerConfig  # noqa: F401

__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig"]
